// Row-layered sum-product (belief propagation) LDPC decoder for Hopper
// (sm_90a), float32.
//
// Replaces the TPU kernel labrador_ldpc_tpu/ops/pallas_sp.py:48
// make_sp_decoder_pallas (lane-major, M >= 512), pinned bit-exact there to the
// XLA twin labrador_ldpc_tpu/ops/sumproduct.py:132 make_sp_decoder_layered,
// which the JAX package serves itself for the M <= 256 codes
// (pallas_sp.py:63-68). One kernel covers all nine codes: the QC structure
// arrives as the packed addend descriptors of qc_addend.cuh
// (ops/cuda_layered.py addend_descriptors). The plain version, the same
// function in the same float32 operations, is
// labrador_ldpc_tpu_torch/ops/sumproduct.py layered_sp_plain.
//
// Per layer, for each check i of the block row:
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
// Design. One CTA decodes one codeword (grid = B). Dynamic shared memory
// holds only the posteriors va (Cc*M floats) and every edge's check message u
// (sumA*M floats, zeroed, so iteration 0 needs no peel: g - 0 is g): TM8192
// takes 163,840 B. Nothing but the input and the result touches device
// memory, and there is no scratch.
//   * Threads. A thread owns K checks of every layer for the whole decode (a
//     warp takes 32 consecutive checks at a time: i = 32*K*warp + lane + 32*k,
//     k < K), so a check's phi sum and sign product are the owner's own
//     registers and need no barrier. The shape (threads, K, shared bytes) is
//     ops/cuda_sp.py launch_config; TM8192 runs one CTA of 1,024 threads an
//     SM, two checks a thread.
//   * The layer's phi values stay in the owner's registers across the
//     barrier between pass 1 and pass 2, with the signs of t as a bit mask
//     (inverted where the sign product is odd, so bit j is u's sign). A
//     register array must be indexed by constants, so the kernel is a
//     template on K and on the widest row W of its code, and both passes
//     unroll over j < W with a uniform predicate j < (this row's width):
//     TM8192 has rows of 3, 6, 6. Where registers allow (K*W <= 12), each
//     addend's variable index is kept too, two to a register; elsewhere pass
//     2 decodes it again. ptxas holds every instance in 64 registers without
//     a spill or a stack frame (chip_smoke.py phase 1 fails otherwise); with
//     the indices kept at W = 18 (TM1280/5120), or with two or four checks a
//     thread beside rows of 8 or 10 addends, it spilled.
//   * Pass 2 synchronises only between runs of addends on distinct block
//     columns (run_end in the descriptor): inside a run each variable is
//     written once, and the barrier between runs keeps the plain version's
//     order of va = va + (u - u_old) where two addends of a row share a
//     column (the I+Pi plane sums). TM8192: 12 barriers an iteration.
//   * The descriptors live in registers (qc::Table, handed out by
//     __shfl_sync): pass 1 and the syndrome decode them, and pass 2 too
//     where the indices are not kept.
//
// What bounds it: the SM's instruction issue. Each edge takes two phi per
// iteration, each an accurate expf, an IEEE division and an accurate logf,
// besides the shared-memory accesses and the index arithmetic, and no memory
// traffic beyond the input and the result. chip_smoke.py (phases 1 and 7)
// counts the SASS of the TM8192 instance per edge visit and turns it into an
// issue floor: on an NVIDIA H100 80GB HBM3 (700 W, 1,980 MHz) about 198
// instructions a visit (pass 1 94, pass 2 72, the syndrome 32; a phi is
// about 50, with two MUFU: EX2 for expf, RCP for the division, logf being a
// polynomial) put the floor at 53 ms for TM8192 at 0.9 dB, B=8192, and the
// kernel takes 57 ms; the one it replaced, with 512 threads an SM and a
// barrier after every addend, took 117 ms.
//
// Exactness against the plain version:
//   * every pass-1 read of va for a layer precedes any write (__syncthreads);
//     pass-2 writes to one variable run in addend order (the run cut above);
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

using qc::kMaxAddends;
using qc::kMaxCols;

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // what one block can address
constexpr int kMaxVars = 65536;             // a variable index packs into 16 bits
constexpr float kPhiEps = 1e-6f;   // ops/sumproduct.py PHI_EPS
constexpr float kPhiClip = 25.0f;  // ops/sumproduct.py PHI_CLIP

// -ln tanh(x/2) of x clamped into [PHI_EPS, PHI_CLIP]; its own inverse
__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, kPhiEps), kPhiClip);
  const float em = expf(-x);
  return logf(__fdiv_rn(__fadd_rn(1.0f, em), __fsub_rn(1.0f, em)));
}

// K checks a thread, rows of at most W addends
template <int K, int W>
__global__ void __launch_bounds__(kMaxThreads) sumproduct_kernel(
    const float* __restrict__ llrs,        // (B, n) true channel LLRs
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    const int* __restrict__ desc,          // (sumA, 2) packed addends
    const int* __restrict__ row_off,       // (R + 1,) first addend of each block row
    int n, int M, int R, int Cc, int sumA, int maxiters) {
  constexpr bool kHoldIdx = K * W <= 12;  // keep the variable indices in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M;
  float* va = reinterpret_cast<float*>(smem_raw);  // (V,) posteriors
  float* us = va + V;                              // (sumA*M,) check messages u

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int qsh = __ffs(M) - 3;  // log2(M / 4)
  const float* llr = llrs + static_cast<size_t>(b) * n;

  qc::Table tab;
  tab.load(desc, sumA);
  // this thread's checks: i0 + 32*k (k < K); with M < 32 (one warp, K = 1)
  // the lanes past M shadow check lane mod M and write nothing
  const int i0 = M < 32 ? tid & (M - 1) : (tid >> 5) * (32 * K) + (tid & 31);
  const bool own = tid < M;

  // posteriors start at the channel LLRs (punctured tail = 0), u at 0
  for (int v = tid; v < V; v += nt) va[v] = v < n ? llr[v] : 0.0f;
  for (int x = tid; x < sumA * M; x += nt) us[x] = 0.0f;
  __syncthreads();

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const int e0 = row_off[r];
      const int w = row_off[r + 1] - e0;
      // what pass 2 needs of each owned check: phi(|t|) of every addend, the
      // phi sum, u's signs (bit j of neg) and, where kept, the variable
      // indices (two 16-bit halves a register); and, uniform across the
      // block, the addends where a new run starts (bit j of cut)
      float ph[K][W], sum[K];
      unsigned neg[K], vx[K][kHoldIdx ? (W + 1) / 2 : 1];
      unsigned cut = 0;
      // pass 1: extrinsics, their phi, the phi sum and the sign product
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < w) {
          const qc::Addend a = tab.fetch(e0 + j);
          cut |= 1u << (a.run_end() - e0);
          const int base = a.col() * M;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int i = i0 + 32 * k;
            const int v = base + a.perm(i, M, qsh);
            const float t = __fsub_rn(va[v], us[(e0 + j) * M + i]);
            const float p = phi(fabsf(t));
            ph[k][j] = p;
            sum[k] = j == 0 ? p : __fadd_rn(sum[k], p);
            const unsigned ng = t < 0.0f ? 1u : 0u;
            neg[k] = j == 0 ? ng : neg[k] | ng << j;
            if constexpr (kHoldIdx)
              vx[k][j / 2] = j % 2 == 0 ? static_cast<unsigned>(v)
                                        : vx[k][j / 2] | static_cast<unsigned>(v) << 16;
          }
        }
      }
      // an odd sign product flips every u's sign: bit j of neg becomes u_j's
#pragma unroll
      for (int k = 0; k < K; ++k) neg[k] ^= (__popc(neg[k]) & 1u) ? ~0u : 0u;
      __syncthreads();  // every read of va for this layer precedes any write
      // pass 2: new u; va[col] += perm_inv(u - u_old) in addend order, with a
      // barrier where a run of addends on distinct block columns ends
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < w) {
          if (j > 0 && ((cut >> j) & 1u)) __syncthreads();  // an earlier run wrote this column
          qc::Addend a{0, 0};
          if constexpr (!kHoldIdx) a = tab.fetch(e0 + j);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int i = i0 + 32 * k;
            const float mag = phi(__fsub_rn(sum[k], ph[k][j]));
            const float u = (neg[k] >> j) & 1u ? -mag : mag;
            int v;
            if constexpr (kHoldIdx)
              v = static_cast<int>((vx[k][j / 2] >> (16 * (j % 2))) & 0xffffu);
            else
              v = a.col() * M + a.perm(i, M, qsh);
            float* up = us + (e0 + j) * M + i;
            const float du = __fsub_rn(u, *up);
            if (own) {
              va[v] = __fadd_rn(va[v], du);
              *up = u;
            }
          }
        }
      }
      __syncthreads();  // the next layer (or the syndrome) reads these posteriors
    }
    // end-of-iteration syndrome over the final posteriors
    unsigned bad = 0;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const int e0 = row_off[r];
      const int w = row_off[r + 1] - e0;
      unsigned par[K];
#pragma unroll
      for (int k = 0; k < K; ++k) par[k] = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < w) {
          const qc::Addend a = tab.fetch(e0 + j);
          const int base = a.col() * M;
#pragma unroll
          for (int k = 0; k < K; ++k)
            par[k] ^= va[base + a.perm(i0 + 32 * k, M, qsh)] < 0.0f ? 1u : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) bad |= own ? par[k] : 0u;
    }
    if (!__syncthreads_or(bad != 0)) {  // uniform across the block
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

// The kernel's instances, one per widest row W of the nine codes, with their
// checks a thread (ops/cuda_sp.py INSTANCES)
struct Instance {
  const void* fn;
  int checks;
};

Instance instance_for(int row_max) {
  switch (row_max) {
    case 6: return {reinterpret_cast<const void*>(sumproduct_kernel<2, 6>), 2};    // TM2048/8192
    case 8: return {reinterpret_cast<const void*>(sumproduct_kernel<1, 8>), 1};    // TC codes
    case 10: return {reinterpret_cast<const void*>(sumproduct_kernel<1, 10>), 1};  // TM1536/6144
    case 18: return {reinterpret_cast<const void*>(sumproduct_kernel<1, 18>), 1};  // TM1280/5120
    default: return {nullptr, 0};
  }
}

// The kernel instance of a launch shape (ops/cuda_sp.py launch_config), after
// checking the shape against the code: nullptr if it does not fit. Shared
// bytes: va and u.
const void* instance(int M, int R, int Cc, int sumA, int row_max, int threads, int checks,
                     int smem) {
  const Instance in = instance_for(row_max);
  const size_t bytes = (static_cast<size_t>(Cc) + sumA) * M * sizeof(float);
  const bool ok = in.fn != nullptr && checks == in.checks && M >= 4 && (M & (M - 1)) == 0 &&
                  R >= 1 && Cc <= kMaxCols && sumA <= kMaxAddends && Cc * M <= kMaxVars &&
                  threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
                  (M < 32 ? threads == 32 && checks == 1 : threads * checks == M) &&
                  static_cast<size_t>(smem) == bytes && bytes <= kMaxSharedBytes;
  return ok ? in.fn : nullptr;
}

// the shared-memory attributes of a kernel instance: its dynamic bytes, and
// the largest carveout, so that as many CTAs fit an SM as its 228 KB allow
cudaError_t prepare(const void* fn, int smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C interface, loaded with ctypes. sumproduct_f32 launches on `stream`
// with the shape of ops/cuda_sp.py launch_config (threads, checks a thread,
// dynamic shared bytes), which it checks against the code first
// (cudaErrorInvalidValue if it does not fit), does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch. sumproduct_f32_config
// reports how many CTAs of that shape fit on one SM of the current card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int sumproduct_f32(const float* llrs, uint8_t* bits, uint8_t* success,
                              int32_t* iterations, const int* desc, const int* row_off, int B,
                              int n, int M, int R, int Cc, int sumA, int row_max, int maxiters,
                              int threads, int checks, int smem, void* stream) {
  const void* fn = instance(M, R, Cc, sumA, row_max, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&llrs, &bits, &success, &iterations, &desc, &row_off, &n, &M, &R, &Cc,
                  &sumA, &maxiters};
  err = cudaLaunchKernel(fn, dim3(B), dim3(threads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sumproduct_f32_config(int M, int R, int Cc, int sumA, int row_max, int threads,
                                     int checks, int smem, int* ctas) {
  const void* fn = instance(M, R, Cc, sumA, row_max, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, smem));
}
