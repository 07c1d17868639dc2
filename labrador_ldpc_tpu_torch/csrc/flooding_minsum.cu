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
// packed addend descriptors of qc_addend.cuh and the arithmetic of
// minsum_arith.cuh. The bfloat16 form (B3/B4 with bf16 LLRs,
// pallas_qc.py:405-455, pallas_tc.py:611, 658) stores every state value in
// bfloat16 and computes in float32: va <- bf16(va + bf16(u)) addend by addend
// (Ar::post), nv = g - u in float32 with the self-correction against the
// stored v, the two-min over |bf16(nv)| (Ar::sat_abs), the sign product and
// parity from the float32 values. The plain version, bit for bit the same
// function, is labrador_ldpc_tpu_torch/ops/qc_minsum.py flooding_minsum_plain.
//
// Per iteration:
//   sweep 1: va = llr + the u of every addend of the variable's block column,
//     in the twin's addend order (saturated after every add in the int forms,
//     rounded in the bf16 form), u from the check's stats;
//   sweep 2, per check: for each addend of its row, u from the old stats,
//     g = va gathered, v = g - u (saturated in the int forms) with the
//     self-correction, the new two-min (seeded at FLT_MAX, or at the int
//     max), the sign product, and the parity of g;
//   the codeword has converged when every parity is 0 (__syncthreads_or,
//     uniform across the block): its bits are the signs of this iteration's
//     sweep-1 posteriors, as the twin's are.
// maxiters = 0 runs no iteration and returns zero bits, success 0 and
// iteration 0, as the twins do (the TPU kernel B3 runs its peeled iteration
// anyway, pallas_qc.py:641).
//
// Design. One CTA decodes one codeword (grid = B). Dynamic shared memory
// holds the posteriors va and the LLRs (staged once, punctured tail 0), two
// planes of V = Cc*M values of T, and each edge's variable index in 16 bits
// (sumA*M): TM8192 takes 143,360 B in float32. Nothing else of a codeword's
// state is in memory, and there is no scratch.
//   * No per-edge message. A read of the twin's stored v asks three things:
//     its sign, whether it is zero, and whether |v| equals its check's m1.
//     The last is "is this edge its check's argmin" (the first addend of the
//     row, in addend order, whose sat_abs(nv) is m1): where another edge ties
//     with it, the two-min has set m2 = m1; where an int edge saturated to
//     -128 (|v| = 128, never a stored min) set m1 = 127, m2 is 127 too. So a
//     check is m1, m2 and one word: its sign product (bit 0), its argmin
//     (bits 1-5) and, for addend j of its row, the sign and the zero test of
//     the stored v = ld(st(nv)) (bits 6 + 2j and 7 + 2j): 32 bits for rows
//     of up to 13 addends, 64 for the 18-addend rows of TM1280/TM5120. The
//     start state (every v = 0, m1 = m2 = 0) has every zero bit set.
//   * One owner per check for the whole decode. Thread t owns offset
//     t + threads*k (k < K) of every block row, and holds its R*K checks'
//     m1, m2 and word in registers. A register array needs constant
//     indices, so the kernel is a template on K, on R and on the widest row
//     W (ops/cuda_qc.py INSTANCES): sweep 2 unrolls over j < W with a
//     uniform predicate j < (this row's width) and builds the new stats in
//     temporaries that it commits at the end of the row (the row's later
//     addends still need the old u); sweep 1 picks the row's registers by a
//     uniform branch on the addend's row. Below 32 checks (TC128) one warp
//     runs and the lanes past M shadow a check and write nothing.
//   * Sweep 1 is the owners' scatter. The twin's order matters only within a
//     block column, so the host cuts the addends into runs, run k holding the
//     k-th addend of every block column (ops/cuda_qc.py flooding_schedule):
//     as many runs as the largest column degree (TM8192 6, for 15 addends),
//     each touching a column at most once. For each addend of a run, the
//     owner of check i computes u from its registers and updates its edge's
//     variable; the first run reads the staged LLRs instead of va (so there
//     is no reset pass, and the punctured tail gets 0 + u, which keeps a -0.0
//     u's sign out of it, as the twin does). Barriers: one after each run and
//     the __syncthreads_or after sweep 2, runs + 1 an iteration (TM8192 7).
//   * Indices. Sweep 1's order lives in registers (one word an addend: its
//     index, row, place in the row and run end, handed out by __shfl_sync;
//     every lane walks the same addend, so the shuffle is warp uniform even
//     where a warp spans several block columns, TC128 with M = 16). At the
//     start of a codeword each owner unpacks the addend descriptors
//     (qc::Addend, read from device memory) into its edges' variable
//     indices; every visit of both sweeps then reads its variable from that
//     plane. The descriptor shuffles and the permutation's index arithmetic
//     it replaces ran on every visit and cost more than the shared-memory
//     read (PERF.md).
//   * The shape (threads, K, shared bytes, CTAs per SM) is
//     ops/cuda_qc.py launch_config: M/K threads (TM8192 1,024, two checks a
//     thread); ptxas gives 30-54 registers, so most codes run more than
//     1,024 threads an SM (TM1536 and TM6144 2,048); shared memory sets the
//     CTAs an SM only for TC512, TM1280 and TM5120 in float32.
//
// What bounds it: the SM's instruction issue. The kernel moves n*sizeof(T) +
// V + 5 bytes per codeword through device memory and does everything else on
// chip; chip_smoke.py (phases 1 and 7) counts the TM8192 instance's SASS per
// edge visit of sweep 1 and sweep 2 and turns it into an issue floor. On an
// NVIDIA H100 80GB HBM3 (700 W, 1,980 MHz): 70.50 instructions an edge visit
// (sweep 1 25.75, sweep 2 44.75, static, both arms of every branch), a floor
// of 4.24 ms at TM8192, B=16384, 3 flips, where the kernel takes 7.59 ms
// (1.79x; 1.61x at Eb/N0 1.1 dB), at one CTA of 1,024 threads an SM and 7
// barriers an iteration; the kernel it replaced, with 512 threads an SM and
// a global table read on every visit, took 17.29 ms.
//
// Exactness against the plain version:
//   * within a run every variable is written once (an addend permutes all M
//     variables of its column, and a run holds a column at most once), and
//     the barrier between runs keeps each column's addends in their order;
//   * every sweep-1 write precedes sweep 2's reads, and every sweep-2 read
//     precedes the next sweep 1's writes (the two barriers);
//   * the roundings are spelled out in minsum_arith.cuh and the build has
//     --fmad=false; the int forms clamp after every add and sub.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "minsum_arith.cuh"
#include "qc_addend.cuh"

namespace {

using qc::kMaxAddends;
using qc::kMaxCols;

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // what one block can address
constexpr int kMaxVars = 65536;             // a variable index fits 16 bits

// a check's word (see the header): 32 bits up to 13 addends a row, else 64
template <int W>
using Word = std::conditional_t<(W <= 13), uint32_t, uint64_t>;

// every addend's "stored v == 0" bit set: the start state
template <int W>
__host__ __device__ constexpr Word<W> zero_bits() {
  Word<W> w = 0;
  for (int j = 0; j < W; ++j) w |= Word<W>(1) << (7 + 2 * j);
  return w;
}

// run word p of sweep 1's order, from the registers where lane l holds words
// l and l + 32 (every lane of the warp must ask for the same p)
__device__ __forceinline__ int run_word(const int (&rw)[2], int p) {
  return __shfl_sync(0xffffffffu, p >= 32 ? rw[1] : rw[0], p & 31);
}

// check -> variable message of addend j of a check with stats (m1, m2, w)
// (decoder.rs:388-405): m2 for the argmin, m1 for the others
template <typename Ar, typename A, typename Wd>
__device__ __forceinline__ A u_msg(A m1, A m2, Wd w, int j, int use_alpha, float alpha) {
  A mag = j == static_cast<int>((w >> 1) & 31) ? m2 : m1;
  if (use_alpha) mag = Ar::scale(alpha, mag);
  return (((w >> (6 + 2 * j)) ^ w) & 1) ? -mag : mag;  // stored v's sign ^ sign product
}

// K checks a thread, R block rows, rows of at most W addends
template <typename T, int K, int R, int W>
__global__ void __launch_bounds__(kMaxThreads) flooding_minsum_kernel(
    const T* __restrict__ llrs,            // (B, n)
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    const int* __restrict__ desc,          // (sumA, 2) packed addends (qc::Addend)
    const int* __restrict__ runs,          // (sumA,) sweep 1's order: e | row << 6 | pos << 8
                                           //   | run_end << 13
    const int* __restrict__ row_off,       // (R + 1,) first addend of each block row
    int n, int M, int Cc, int sumA, int maxiters, int use_alpha, float alpha) {
  using Ar = ms::Arith<T>;
  using A = typename Ar::A;  // float for float32/bfloat16, int for int8/int16
  using Wd = Word<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M;
  T* va = reinterpret_cast<T*>(smem_raw);  // (V,) posteriors of this iteration
  T* sl = va + V;                          // (V,) the LLRs, punctured tail 0
  uint16_t* vix = reinterpret_cast<uint16_t*>(sl + V);  // (sumA*M,) variable of edge (e, i)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int qsh = __ffs(M) - 3;  // log2(M / 4)
  const T* llr = llrs + static_cast<size_t>(b) * n;

  int rw[2];  // sweep 1's order: lane l holds run words l and l + 32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = (tid & 31) + 32 * h;
    rw[h] = p < sumA ? runs[p] : 0;
  }
  // this thread's checks: offset i0 + nt*k of every row; with M < 32 (one
  // warp, K = 1) the lanes past M shadow check lane mod M and write nothing
  const int i0 = M < 32 ? tid & (M - 1) : tid;
  const bool own = tid < M;

  // the reference zeroes its working area (decoder.rs:374): v, m1, m2, sign
  A m1[K][R], m2[K][R];
  Wd wd[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m1[k][q] = A(0);
      m2[k][q] = A(0);
      wd[k][q] = zero_bits<W>();
    }
  }
  for (int v = tid; v < V; v += nt) sl[v] = v < n ? llr[v] : Ar::st(A(0));
  // the variable of each of this thread's edges, once per codeword
#pragma unroll 1
  for (int e = 0; e < sumA; ++e) {
    const qc::Addend a{__ldg(desc + 2 * e), __ldg(desc + 2 * e + 1)};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + nt * k;
      if (own) vix[e * M + i] = static_cast<uint16_t>(a.col() * M + a.perm(i, M, qsh));
    }
  }
  __syncthreads();

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
    // sweep 1: the owners scatter u into the posteriors, run by run; the
    // first run starts each column from its LLRs
    int p = 0;
#pragma unroll 1
    for (int run = 0; p < sumA; ++run) {
      const T* src = run == 0 ? sl : va;
      const int end = (run_word(rw, p) >> 13) & 63;
#pragma unroll 1
      for (; p < end; ++p) {
        const int word = run_word(rw, p);
        const int r = (word >> 6) & 3, j = (word >> 8) & 31;
        const uint16_t* ix = vix + (word & 63) * M;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (q == r) {  // uniform: the register arrays need a constant row
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const A u = u_msg<Ar>(m1[k][q], m2[k][q], wd[k][q], j, use_alpha, alpha);
              const int v = ix[i0 + nt * k];
              const A x = Ar::sat(Ar::post(Ar::ld(src[v]), u));
              if (own) va[v] = Ar::st(x);
            }
          }
        }
      }
      __syncthreads();  // the next run (or sweep 2) reads these posteriors
    }

    // sweep 2: self-corrected v, the checks' new stats and the parity of g.
    // A loop over the rows, not unrolled (unrolled, the compiler hoisted each
    // row's loop-invariant addend work out of the iteration loop and spilled
    // it): each row's stats sit in slot 0 of the register arrays when its
    // turn comes, and the slots rotate by one after every row, R in all
    unsigned bad = 0;
#pragma unroll 1
    for (int q = 0, e0 = 0; q < R; ++q) {
      const int w = __ldg(row_off + q + 1) - e0;
      A n1[K], n2[K];
      Wd nw[K];
      int arg[K];
      unsigned par[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        n1[k] = Ar::big();
        n2[k] = Ar::big();
        nw[k] = 0;
        arg[k] = 0;
        par[k] = 0;
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < w) {
          const uint16_t* ix = vix + (e0 + j) * M;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const Wd wo = wd[k][0];
            const Wd neg_bit = Wd(1) << (6 + 2 * j), zero_bit = neg_bit << 1;
            const A u = u_msg<Ar>(m1[k][0], m2[k][0], wo, j, use_alpha, alpha);
            const A g = Ar::ld(va[ix[i0 + nt * k]]);
            A nv = Ar::sat(Ar::sub(g, u));
            const bool neg_old = (wo & neg_bit) != 0, zero_old = (wo & zero_bit) != 0;
            nv = ((nv < A(0)) == neg_old) || zero_old ? nv : A(0);  // decoder.rs:420-426
            if (g < A(0)) par[k] ^= 1u;
            const A a1 = Ar::sat_abs(nv);
            const bool lower = a1 < n1[k];
            arg[k] = lower ? j : arg[k];  // the first addend at the row's m1
            n2[k] = lower ? n1[k] : Ar::min(n2[k], a1);
            n1[k] = Ar::min(n1[k], a1);
            const A sv = Ar::ld(Ar::st(nv));  // v as the twin stores it
            if (nv < A(0)) nw[k] ^= Wd(1);
            if (sv < A(0)) nw[k] |= neg_bit;
            if (sv == A(0)) nw[k] |= zero_bit;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {  // the row is done: its old stats are spent
#pragma unroll
        for (int x = 0; x + 1 < R; ++x) {
          m1[k][x] = m1[k][x + 1];
          m2[k][x] = m2[k][x + 1];
          wd[k][x] = wd[k][x + 1];
        }
        m1[k][R - 1] = n1[k];
        m2[k][R - 1] = n2[k];
        wd[k][R - 1] = nw[k] | Wd(arg[k]) << 1;
        bad |= own ? par[k] : 0u;
      }
      e0 += w;
    }
    if (!__syncthreads_or(bad)) {  // uniform across the block; also the barrier
      converged = 1;               // before the next sweep 1 writes va
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

// The kernel instance of a launch shape (ops/cuda_qc.py launch_config), after
// checking the shape against the code: nullptr if it does not fit. One
// instance per widest row W of the nine codes, with its checks a thread and
// block rows (ops/cuda_qc.py INSTANCES). Shared bytes: va and the LLRs in
// T, and each edge's variable in 16 bits.
template <typename T>
const void* instance(int M, int R, int Cc, int sumA, int row_max, int n, int threads,
                     int checks, int smem) {
  const void* fn;
  int k, r;
  switch (row_max) {
    case 6:  // TM2048/8192
      fn = reinterpret_cast<const void*>(flooding_minsum_kernel<T, 2, 3, 6>), k = 2, r = 3;
      break;
    case 8:  // TC codes
      fn = reinterpret_cast<const void*>(flooding_minsum_kernel<T, 1, 4, 8>), k = 1, r = 4;
      break;
    case 10:  // TM1536/6144
      fn = reinterpret_cast<const void*>(flooding_minsum_kernel<T, 1, 3, 10>), k = 1, r = 3;
      break;
    case 18:  // TM1280/5120
      fn = reinterpret_cast<const void*>(flooding_minsum_kernel<T, 1, 3, 18>), k = 1, r = 3;
      break;
    default:
      return nullptr;
  }
  const size_t bytes =
      2 * static_cast<size_t>(Cc) * M * sizeof(T) + static_cast<size_t>(sumA) * M * sizeof(uint16_t);
  const bool ok = checks == k && R == r && M >= 4 && (M & (M - 1)) == 0 && Cc <= kMaxCols &&
                  sumA <= kMaxAddends && n <= Cc * M && Cc * M <= kMaxVars && threads >= 32 &&
                  threads <= kMaxThreads && threads % 32 == 0 &&
                  (M < 32 ? threads == 32 && checks == 1 : threads * checks == M) &&
                  static_cast<size_t>(smem) == bytes && bytes <= kMaxSharedBytes;
  return ok ? fn : nullptr;
}

// the shared-memory attributes of a kernel instance: its dynamic bytes, and
// the largest carveout, so that as many CTAs fit an SM as its 228 KB allow
cudaError_t prepare(const void* fn, int smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations, const int* desc,
           const int* runs, const int* row_off, int B, int n, int M, int R, int Cc, int sumA, int row_max,
           int maxiters, int use_alpha, float alpha, int threads, int checks, int smem,
           void* stream) {
  const void* fn = instance<T>(M, R, Cc, sumA, row_max, n, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&llrs, &bits, &success, &iterations, &desc, &runs, &row_off, &n, &M, &Cc,
                  &sumA, &maxiters, &use_alpha, &alpha};
  err = cudaLaunchKernel(fn, dim3(B), dim3(threads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ctas_per_sm(int M, int R, int Cc, int sumA, int row_max, int n, int threads, int checks,
                int smem, int* ctas) {
  const void* fn = instance<T>(M, R, Cc, sumA, row_max, n, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, smem));
}

}  // namespace

// Plain C interface, loaded with ctypes, one entry point per LLR dtype
// (bfloat16 as __nv_bfloat16, the bits of a torch.bfloat16). NAME launches on
// `stream` with the shape of ops/cuda_qc.py launch_config (threads, checks a
// thread, dynamic shared bytes), which it checks against the code first
// (cudaErrorInvalidValue if it does not fit), does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch; NAME_ctas_per_sm
// reports how many CTAs of that shape fit on one SM of the current card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
#define FLOODING_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,     \
                      const int* desc, const int* runs, const int* row_off, int B, int n,      \
                      int M, int R, int Cc, int sumA, int row_max, int maxiters,               \
                      int use_alpha, float alpha, int threads, int checks, int smem,           \
                      void* stream) {                                                          \
    return launch<T>(llrs, bits, success, iterations, desc, runs, row_off, B, n, M, R, Cc,     \
                     sumA, row_max, maxiters, use_alpha, alpha, threads, checks, smem,         \
                     stream);                                                                  \
  }                                                                                            \
  extern "C" int NAME##_ctas_per_sm(int M, int R, int Cc, int sumA, int row_max, int n,        \
                                    int threads, int checks, int smem, int* ctas) {            \
    return ctas_per_sm<T>(M, R, Cc, sumA, row_max, n, threads, checks, smem, ctas);            \
  }

FLOODING_ENTRY(flooding_minsum_f32, float)
FLOODING_ENTRY(flooding_minsum_bf16, __nv_bfloat16)
FLOODING_ENTRY(flooding_minsum_i8, int8_t)
FLOODING_ENTRY(flooding_minsum_i16, int16_t)
