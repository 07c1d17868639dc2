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
// qc_structure) arrives as two packed int32 words per addend
// (ops/cuda_layered.py addend_descriptors), so a block permutation is index
// arithmetic instead of the TPU kernels' static rolls. The plain version, bit
// for bit the same function, is labrador_ldpc_tpu_torch/ops/qc_minsum.py
// layered_minsum_plain.
//
// The int8/int16 forms (B1/B2 with int LLRs; twin make_ms_decoder_layered with
// an int dtype, qc_minsum.py:283-357) are the same template over the storage
// type T of the LLRs and of t' and the check statistics (minsum_arith.cuh):
// t = sat(g - u_old), the self-correction against the stored (saturated) t',
// a1 = min(|t|, HI) with the two-min seeded at HI, and the posterior va kept
// WIDE in int32 and never clipped (its bound, (1 + degree) * 32767, is below
// 2^24). Float32 keeps every rounding of the plain version: Arith<float>
// spells each one out.
//
// The bfloat16 form (B1/B2 with bf16 LLRs, pallas_qc.py:880-1006,
// pallas_tc.py:339-410) stores the LLRs, the posteriors, t' and the check
// statistics in bfloat16 and computes in float32: t = g - u_old stays float32
// (the self-correction and the sign product read it), the two-min takes
// |bf16(t)| (Ar::sat_abs), u = +-mag is float32 (alpha * mag a float32
// product), the posterior update rounds twice, va <- bf16(va + bf16(u -
// u_old)) (Ar::post), and the u_old a stored u would have given is
// bf16(+-mag). The sign of bf16(t), which pass 2 reads back, is the sign of t:
// t is a difference of two bfloat16 values, so it is zero only where bf16(t)
// is.
//
// Design. One CTA decodes one codeword (grid = B), and its whole decoder
// state lives in dynamic shared memory; nothing but the input, the result and
// two small read-only tables touches device memory, and there is no scratch:
//   * va, the posteriors: V values (float32 or int32; bfloat16 in the bf16
//     form, which only ever holds bfloat16 values there);
//   * t', each edge's previous self-corrected extrinsic: sumA*M values of T;
//   * m1, m2, each check's two smallest |t| of its last visit: 2*R*M values
//     of T (storage-rounded |t| values, so T holds them exactly);
//   * the checks' sign products, a bit a check: R*M/32 words (rounded up),
//     check c = r*M + i at bit c mod 32 of word c/32, a warp's ballot of its
//     32 consecutive checks (TC128's rows of 16 checks take half a word);
//   * the hard decisions of the posteriors, a bit a variable: Cc*W words
//     (W = M/32, and one for M = 16), block column c at words c*W onward
//     (TC128's 16-variable column twice in one word), the syndrome's input.
// There is no per-edge u. The previous iteration's u of an edge is a pure
// function of its t' and its check's (m1, m2, sign) of that iteration:
//   u_old = st(sign ^ (t' < 0) ? -mag : mag),
//   mag = alpha * (sat_abs(t') == m1 ? m2 : m1),
// the expression that produced the stored u, replayed (the JAX package pins
// the same identity for its TPU kernel: pallas_qc.py:770-779, :994-1006,
// tests/test_pallas.py test_pallas_layered_recompute_u_bit_exact). TM8192
// takes 215,040 B in float32 (108,544 B in bfloat16, 86,016 B in int8,
// 129,024 B in int16), under the 232,448 B a block can address.
//
// The end-of-iteration syndrome runs on the packed hard decisions, as the
// bit-flip kernel's parity words do (csrc/bitflip.cu): each warp packs 32
// posteriors a ballot (va < 0, so -0.0 counts as 0), and check word pw
// (checks 32*(pw mod W) on of row pw / W) is the XOR, over the row's
// addends, of a 32-bit window of the addend's packed segment (the block
// column for a rotation, a quarter of it for a pi permutation), starting at
// perm of the word's first check and wrapping at the segment's end. A window
// is one entry of the table `win` (ops/cuda_layered.syndrome_windows: the
// bit-flip kernel's forward entries), two word loads and one funnel shift:
// TM8192 forms 192 check words from 960 windows a sweep, where a per-edge
// syndrome visited 30,720 edges.
//
// Threads. A thread owns K checks of every layer for the whole decode (a warp
// takes 32 consecutive checks at a time: i = 32*K*warp + lane + 32*k, k < K,
// so a per-check address is a base plus a constant), and it alone reads and
// writes their t', m1 and m2 slots, and its warp alone their sign word:
// those need no barrier. Across the barrier between pass 1 and pass 2 it
// carries, per check, the two u_old magnitudes and two bit masks (which
// magnitude and which sign each addend's u_old had; bit 31 of the first, the
// check's new sign product) in registers, so pass 2 rebuilds u_old without
// the old statistics, which pass 1 has overwritten. The shape (threads, K,
// shared bytes) is ops/cuda_layered.py launch_config: the CTAs that fit an
// SM's shared memory, times the threads, stay within 1,024 threads an SM, so
// the kernel's 64-register budget (__launch_bounds__(1024, 1); without the
// 1, ptxas gave the int8/int16 instances of one check a thread 32 registers
// and a spill) does not limit the CTAs on an SM below what shared memory
// allows (K is at most 4: K = 8 spills; for TM2048 int8 launch_config
// therefore counts 8 CTAs an SM where shared memory holds 10, and the card, at
// ptxas's 56 registers, runs 9). The addend table stays in registers:
// lane l of every warp holds addends l and l + 32 and hands them out with
// __shfl_sync.
//
// What bounds it now: the instruction stream of an edge visit (the
// descriptor shuffle, the permutation's index arithmetic, a shared-memory
// access, the u_old rebuild), two visits per edge and iteration (pass 1 and
// pass 2; the syndrome is 1/32 of a visit an edge), with the CTAs of one SM
// sharing 1,024 threads. Before the packed syndrome, on an NVIDIA H100 80GB
// HBM3 (700 W), every form took 9.8-10.5 ms per TM8192 serving batch
// (B=16384, chip_smoke.py), whatever its state bytes or its CTAs per SM.
//
// Where the old design's time went (the earlier global-scratch design,
// NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): u and t'
// lived in a (B, sumA, M) global scratch (4.03 GB in float32 at TM8192,
// B=16384), and va plus three stat planes (65,536 B) in shared memory, with
// 256 threads and 3 CTAs an SM. Every edge visit of pass 1 and pass 2 waited
// on a dependent global load of u and t', with a barrier after every addend
// of pass 2: 18.32 ms per TM8192 serving batch, 41x its operations bound, and
// the bf16 form, with half the bytes, took the same time, so the time was
// latency, not bandwidth (7.38 ms of state traffic at 3.35 TB/s, computed).
//
// Exactness against the plain version:
//   * all pass-1 reads of va for a layer complete before any write
//     (__syncthreads), and the writes va += du to a variable run in the
//     twin's addend order: the host cuts each layer into runs of addends on
//     distinct block columns (every row of every code has two or three
//     addends on one block column, the I+Pi plane sums), with a barrier
//     between runs; inside a run the writes touch distinct variables, so a
//     thread may take its checks one at a time through it;
//   * the posterior update is va + (u - u_old), never (va - u_old) + u;
//   * no FMA contraction: built with --fmad=false, and the roundings are
//     spelled out with __fadd_rn/__fsub_rn/__fmul_rn besides.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "minsum_arith.cuh"
#include "qc_addend.cuh"

namespace {

using qc::kMaxAddends;
using qc::kMaxCols;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxAddendsPerRow = 31;  // one bit each in the u_old masks; bit 31: the sign
constexpr size_t kMaxSharedBytes = 232448;  // what one block can address

// The posteriors as stored in shared memory: the compute type, except in the
// bf16 form, whose posteriors are always bfloat16 values.
template <typename T>
struct Post {
  using A = typename ms::Arith<T>::A;
  using S = A;
  __device__ static __forceinline__ A ld(S x) { return x; }
  __device__ static __forceinline__ S st(A x) { return x; }
};

template <>
struct Post<__nv_bfloat16> {
  using S = __nv_bfloat16;
  __device__ static __forceinline__ float ld(S x) { return __bfloat162float(x); }
  __device__ static __forceinline__ S st(float x) { return __float2bfloat16_rn(x); }
};

// The two u_old magnitudes of a check, as stored (scaled, rounded to T):
// two registers in float32, one (two 16-bit halves) in the narrower forms.
template <typename T>
struct Mags {
  using A = typename ms::Arith<T>::A;
  unsigned w;
  __device__ __forceinline__ void set(A u1, A u2) { w = bits(u1) | bits(u2) << 16; }
  __device__ __forceinline__ A get(bool second) const {
    return ms::Arith<T>::ld(unbits((second ? w >> 16 : w) & 0xffffu));
  }
  __device__ static __forceinline__ unsigned bits(A x) {
    if constexpr (sizeof(T) == 1) return static_cast<uint8_t>(ms::Arith<T>::st(x));
    else if constexpr (std::is_integral_v<T>) return static_cast<uint16_t>(ms::Arith<T>::st(x));
    else return __bfloat16_as_ushort(ms::Arith<T>::st(x));
  }
  __device__ static __forceinline__ T unbits(unsigned b) {
    if constexpr (std::is_integral_v<T>) return static_cast<T>(b);
    else return __ushort_as_bfloat16(static_cast<unsigned short>(b));
  }
};

template <>
struct Mags<float> {
  float m[2];
  __device__ __forceinline__ void set(float u1, float u2) { m[0] = u1; m[1] = u2; }
  __device__ __forceinline__ float get(bool second) const { return second ? m[1] : m[0]; }
};

// The 32-bit window of entry `ent` (ops/cuda_layered.syndrome_windows): b |
// w0 << 5 | w1 << 18, the 32 bits from bit b of word w0 of `src` on,
// continued in word w1 (the next word of the window's segment, which wraps).
__device__ __forceinline__ uint32_t window(const uint32_t* src, int ent) {
  return __funnelshift_r(src[(ent >> 5) & 0x1fff], src[ent >> 18], ent);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, 1) layered_minsum_kernel(
    const T* __restrict__ llrs,            // (B, n)
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    const int* __restrict__ desc,          // (sumA, 2) packed addends
    const int* __restrict__ row_off,       // (R + 1,) first addend of each block row
    const int* __restrict__ win,           // (sumA, W) syndrome windows, by row
    int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha, float alpha) {
  using Ar = ms::Arith<T>;
  using A = typename Ar::A;  // float for float32/bfloat16, int (wide) for int8/int16
  using P = Post<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M, RM = R * M;
  typename P::S* va = reinterpret_cast<typename P::S*>(smem_raw);  // (V,) posteriors
  T* tps = reinterpret_cast<T*>(va + V);                 // (sumA*M,) t' of every edge
  T* m1s = tps + static_cast<size_t>(sumA) * M;          // (R*M,) smallest |t| of each check
  T* m2s = m1s + RM;                                     // (R*M,) second smallest
  uint32_t* sgw = reinterpret_cast<uint32_t*>(m2s + RM);  // (RM/32,) sign products, a bit a check
  uint32_t* hd = sgw + ((RM + 31) >> 5);  // (Cc*W,) hard decisions, a bit a variable

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int qsh = __ffs(M) - 3;  // log2(M / 4)
  const T* llr = llrs + static_cast<size_t>(b) * n;

  qc::Table tab;
  tab.load(desc, sumA);
  // this thread's checks: i0 + 32*k (k < K), so that a warp's lanes take 32
  // consecutive checks at a time and every per-check address is one base plus
  // a constant; with M < 32 (one warp, K = 1) the lanes past M shadow check
  // lane mod M and write nothing
  const int i0 = M < 32 ? tid & (M - 1) : (tid >> 5) * (32 * K) + (tid & 31);
  const bool own = tid < M;

  // posteriors start at the channel LLRs; punctured tail = 0
  for (int v = tid; v < V; v += nt) va[v] = P::st(v < n ? Ar::ld(llr[v]) : A(0));
  __syncthreads();

  int it_done = maxiters;  // below maxiters: converged there
  for (int it = 0; it < maxiters; ++it) {
    const bool first = it == 0;  // u = t' = 0: peeled, no state read
    for (int r = 0; r < R; ++r) {
      const int e0 = row_off[r], e1 = row_off[r + 1];
      // per owned check, what pass 2 needs of u_old: its two magnitudes and,
      // per addend, which one (bit e - e0 of which[k]) and its sign (neg[k]);
      // and the check's new sign product (bit 31 of which[k])
      Mags<T> mags[K];
      unsigned which[K], neg[K];
      // pass 1: u_old from t' and the old stats; t = perm(va) - u_old with the
      // self-correction; t to the t' slot; the check's new two-min and sign
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = i0 + 32 * k;
        const int c = r * M + i;
        A m1o = A(0), u1 = A(0), u2 = A(0);
        bool sgo = false;
        if (!first) {
          m1o = Ar::ld(m1s[c]);
          const A m2o = Ar::ld(m2s[c]);
          sgo = (sgw[c >> 5] >> (c & 31)) & 1u;
          // the stored u's magnitudes: scaled, then rounded to T
          u1 = Ar::ld(Ar::st(use_alpha ? Ar::scale(alpha, m1o) : m1o));
          u2 = Ar::ld(Ar::st(use_alpha ? Ar::scale(alpha, m2o) : m2o));
        }
        A m1 = Ar::big(), m2 = Ar::big();
        int sg = 0;
        unsigned wh = 0, ng = 0;
#pragma unroll 1
        for (int e = e0; e < e1; ++e) {
          const qc::Addend a = tab.fetch(e);
          const A g = P::ld(va[a.col() * M + a.perm(i, M, qsh)]);
          A u_old = A(0), tp = A(0);
          if (!first) {
            tp = Ar::ld(tps[e * M + i]);
            const bool sel = Ar::sat_abs(tp) == m1o;  // equality tie rule
            const bool flip = sgo != (tp < A(0));
            const A mag = sel ? u2 : u1;
            u_old = flip ? -mag : mag;
            wh |= (sel ? 1u : 0u) << (e - e0);
            ng |= (flip ? 1u : 0u) << (e - e0);
          }
          A t = Ar::sat(Ar::sub(g, u_old));
          const bool keep = ((t < A(0)) == (tp < A(0))) || (tp == A(0));
          t = keep ? t : A(0);
          if (own) tps[e * M + i] = Ar::st(t);
          const A a1 = Ar::sat_abs(t);
          m2 = a1 < m1 ? m1 : Ar::min(m2, a1);
          m1 = Ar::min(m1, a1);
          sg ^= t < A(0) ? 1 : 0;
        }
        // the warp's 32 sign products in one word (every lane has read the
        // old word, which its sg depends on); TC128's 16 owners fill the
        // row's half of a word and keep the other row's half
        const unsigned sgword = __ballot_sync(kFull, sg != 0);
        if (own) {  // the old stats are consumed: mags, wh, ng carry them
          m1s[c] = Ar::st(m1);
          m2s[c] = Ar::st(m2);
        }
        if (lane == 0) {
          sgw[c >> 5] = M >= 32 ? sgword
                                : (sgw[c >> 5] & (0xffff0000u >> (c & 16))) |
                                      (sgword & 0xffffu) << (c & 16);
        }
        mags[k].set(u1, u2);
        which[k] = wh | static_cast<unsigned>(sg) << 31;
        neg[k] = ng;
      }
      __syncthreads();  // every read of va for this layer precedes any write
      // pass 2: new u from t' and the new stats; va[col] += perm_inv(u - u_old)
      // in addend order. Within a run of addends on distinct block columns the
      // writes touch distinct variables, so a thread takes its checks one at a
      // time through the run; between runs, a barrier.
      for (int s0 = e0; s0 < e1;) {
        const int s1 = tab.fetch(s0).run_end();
        if (s0 > e0) __syncthreads();  // an addend of an earlier run wrote this column
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = i0 + 32 * k;
          const int c = r * M + i;
          const A m1 = Ar::ld(m1s[c]), m2 = Ar::ld(m2s[c]);
          const bool sg = which[k] >> 31;
#pragma unroll 1
          for (int e = s0; e < s1; ++e) {
            const qc::Addend a = tab.fetch(e);
            const A t = Ar::ld(tps[e * M + i]);
            A mag = Ar::sat_abs(t) == m1 ? m2 : m1;  // equality tie rule
            if (use_alpha) mag = Ar::scale(alpha, mag);
            const A u = (sg != (t < A(0))) ? -mag : mag;
            const int bit = e - e0;
            const A um = mags[k].get((which[k] >> bit) & 1);
            const A u_old = first ? A(0) : ((neg[k] >> bit) & 1 ? -um : um);
            typename P::S* x = va + a.col() * M + a.perm(i, M, qsh);
            if (own) *x = P::st(Ar::post(P::ld(*x), Ar::sub(u, u_old)));  // int: wide
          }
        }
        s0 = s1;
      }
      __syncthreads();  // the next layer (or the syndrome) reads these posteriors
    }
    // end-of-iteration syndrome over the final posteriors: their hard
    // decisions packed 32 a ballot (TC128's column of 16 twice a word) ...
    const int W = M >= 32 ? M >> 5 : 1;  // words of a packed block column or row
    for (int w = tid >> 5; w < Cc * W; w += nt >> 5) {  // uniform across a warp
      const int v = M >= 32 ? (w << 5) | lane : (w << 4) | (lane & 15);
      const unsigned word = __ballot_sync(kFull, P::ld(va[v]) < A(0));
      if (lane == 0) hd[w] = word;
    }
    __syncthreads();
    // ... then each check word the XOR of its row's windows
    unsigned bad = 0;
    for (int pw = tid; pw < R * W; pw += nt) {
      const int r = pw >> (__ffs(W) - 1);
      uint32_t par = 0;
      for (int e = row_off[r] * W + (pw & (W - 1)); e < row_off[r + 1] * W; e += W) {
        par ^= window(hd, win[e]);
      }
      bad |= par;
    }
    if (!__syncthreads_or(bad != 0)) {  // uniform across the block
      it_done = it;
      break;  // the bits of this iteration are the frozen result
    }
  }

  // a converged codeword reports the signs of its convergence iteration, a
  // failed one those of its last; no iteration at all (maxiters = 0) gives 0
  uint8_t* out = bits + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += nt) out[v] = (maxiters > 0 && P::ld(va[v]) < A(0)) ? 1 : 0;
  if (tid == 0) {
    success[b] = static_cast<uint8_t>(it_done < maxiters);
    iterations[b] = it_done;
  }
}

// the shared bytes of one codeword's state: va, t', m1, m2 (T), and the
// packed signs (R*M/32 words) and hard decisions (W words a block column)
template <typename T>
size_t shared_bytes(int M, int R, int Cc, int sumA) {
  const size_t m = static_cast<size_t>(M), rm = R * m, w = M >= 32 ? m / 32 : 1;
  return Cc * m * sizeof(typename Post<T>::S) + (sumA * m + 2 * rm) * sizeof(T) +
         4 * ((rm + 31) / 32 + Cc * w);
}

// The kernel instance of a launch shape (ops/cuda_layered.py launch_config),
// after checking the shape against the code: nullptr if it does not fit.
template <typename T>
const void* instance(int M, int R, int Cc, int sumA, int row_max, int threads, int checks,
                     int smem) {
  const bool ok = M >= 16 && (M & (M - 1)) == 0 && R >= 1 && Cc <= kMaxCols &&
                  sumA <= kMaxAddends && row_max <= kMaxAddendsPerRow && threads >= 32 &&
                  threads <= kMaxThreads && threads % 32 == 0 &&
                  (M < 32 ? threads == 32 && checks == 1 : threads * checks == M) &&
                  static_cast<size_t>(smem) == shared_bytes<T>(M, R, Cc, sumA) &&
                  static_cast<size_t>(smem) <= kMaxSharedBytes;
  if (!ok) return nullptr;
  switch (checks) {
    case 1: return reinterpret_cast<const void*>(layered_minsum_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(layered_minsum_kernel<T, 2>);
    case 4: return reinterpret_cast<const void*>(layered_minsum_kernel<T, 4>);
    default: return nullptr;
  }
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
           const int* row_off, const int* win, int B, int n, int M, int R, int Cc, int sumA,
           int row_max, int maxiters, int use_alpha, float alpha, int threads, int checks, int smem,
           void* stream) {
  const void* fn = instance<T>(M, R, Cc, sumA, row_max, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&llrs, &bits, &success, &iterations, &desc, &row_off, &win, &n, &M, &R,
                  &Cc, &sumA, &maxiters, &use_alpha, &alpha};
  err = cudaLaunchKernel(fn, dim3(B), dim3(threads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ctas_per_sm(int M, int R, int Cc, int sumA, int row_max, int threads, int checks, int smem,
                int* ctas) {
  const void* fn = instance<T>(M, R, Cc, sumA, row_max, threads, checks, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads, smem));
}

}  // namespace

// Plain C interface, loaded with ctypes, one entry point per LLR dtype
// (bfloat16 as __nv_bfloat16, the bits of a torch.bfloat16). Each launches on
// `stream` with the tables of ops/cuda_layered.py (the packed addends, the
// layer offsets and the syndrome windows) and the shape of its launch_config
// (threads, checks a thread, dynamic shared bytes), which it checks against the code
// first (cudaErrorInvalidValue if it does not fit), does not synchronise,
// allocates nothing, and returns the cudaError_t of the launch. Each
// *_ctas_per_sm reports how many CTAs of that shape fit on one SM of the
// current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
#define LAYERED_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,     \
                      const int* desc, const int* row_off, const int* win, int B, int n, int M, \
                      int R, int Cc, int sumA, int row_max, int maxiters, int use_alpha,       \
                      float alpha, int threads, int checks, int smem, void* stream) {          \
    return launch<T>(llrs, bits, success, iterations, desc, row_off, win, B, n, M, R, Cc,      \
                     sumA, row_max, maxiters, use_alpha, alpha, threads, checks, smem,         \
                     stream);                                                                  \
  }                                                                                            \
  extern "C" int NAME##_ctas_per_sm(int M, int R, int Cc, int sumA, int row_max, int threads,  \
                                    int checks, int smem, int* ctas) {                         \
    return ctas_per_sm<T>(M, R, Cc, sumA, row_max, threads, checks, smem, ctas);               \
  }

LAYERED_ENTRY(layered_minsum_f32, float)
LAYERED_ENTRY(layered_minsum_bf16, __nv_bfloat16)
LAYERED_ENTRY(layered_minsum_i8, int8_t)
LAYERED_ENTRY(layered_minsum_i16, int16_t)
