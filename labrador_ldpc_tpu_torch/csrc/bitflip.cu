// Gallager bit-flip LDPC decoder with the punctured-tail erasure pass, for
// Hopper (sm_90a), on a bit-packed codeword.
//
// Replaces two TPU kernels of the JAX package, both pinned bit-exact to the
// XLA twin labrador_ldpc_tpu/ops/bitflip.py:269 make_bf_decoder_qc:
//   * labrador_ldpc_tpu/ops/pallas_bf.py:53 make_bf_decoder_pallas
//     (lane-major, M >= 512: TM2048/5120/6144/8192), and
//   * labrador_ldpc_tpu/ops/pallas_tc.py:741 make_bf_decoder_pallas_tc
//     (node-major, M <= 256: TC128/256/512, TM1280/1536).
// One kernel covers all nine codes. The plain version, bit for bit the same
// function, is labrador_ldpc_tpu_torch/ops/bitflip.py bitflip_plain; the
// launch shape and the window table come from ops/cuda_bf.py (launch_config,
// window_table).
//
// Design. A codeword is a group of `lanes` lanes of one warp (32 for the TM
// codes but TM1280, 16 there, 8 for TC512, 4 for TC128/256), and a CTA of 256
// threads holds 256 / lanes codewords. Each codeword's state is bit-packed in
// shared memory, 32 variables or checks a word: its V bits (block column c
// at words c*W onward, W = M/32), the R*M check parities (row r at words r*W)
// and its three violation-count planes (TM8192: 320 + 192 + 960 words, 5,888
// B). TC128 (M = 16) keeps each block column, and each row's parities, as
// its 16 bits twice over in one word: a rotation of a word of period 16 is a
// rotation of the column, so one code path serves every code. Per iteration:
//   1. parity words: XOR, over the row's addends, of a 32-bit window of the
//      addend's packed block column: checks i..i+31 read variables perm(i)
//      onward, consecutive in the addend's segment (the block for a
//      rotation, a quarter for a pi permutation) and wrapping there. A
//      window is one table entry, two word loads and one funnel shift;
//   2. no parity word set: converged at this iteration (the twin's `ok`;
//      the maximum count is 0 exactly then);
//   3. count words: a carry-save add of the inverse windows of the column's
//      addends (of the packed parities) into three bit planes (a count is at
//      most the column's degree, at most 6: the wrapper refuses wider
//      columns); two addends of one row on one column add twice, as the
//      twin's scatter per addend;
//   4. the maximum, bit-sliced from plane 2 down: seven OR accumulators and
//      three ballots; the flip set is "count == maximum", every such bit
//      flipped at once.
// The early exit is per codeword; a warp runs until its last codeword is
// done, with the finished ones idle. There is no __syncthreads in the
// iteration loop, only __syncwarp, and no division: the window table holds
// every entry's word and bit (ops/cuda_bf.window_table), read from shared
// memory, where the CTA copies it once.
//
// The CTAs stay resident (the wrapper launches at most the card's resident
// CTAs) and a lane group that is done takes the batch's next codeword from
// a counter in device memory (one int32, set to 0 by this entry point on the
// stream): where sweeps range from 1 to 50 (a BSC batch) no slot waits on
// another's slowest codeword.
//
// Punctured codes start with one erasure voting pass, only when maxiters > 0
// (with maxiters == 0 the twin runs none). Every punctured code has exactly
// one voting addend (the wrapper refuses more): the only row with a single
// addend on the erased last block column. So a tail bit becomes 1 exactly
// when the parity of its voting check, over the bits with the tail at 0, is
// 1: the tail words are the inverse windows of that row's parity words.
//
// Input and output are packed and unpacked at the edges: each lane loads 16
// hard-bit bytes at once (the wrapper passes a 16-byte aligned batch) and
// gathers their bit 0 into 16 bits with one multiply a 4 bytes; the output
// is spread back the same way and stored 16 bytes at a time.
//
// What bounds it: the SM's integer pipe. Device memory sees only the input
// and the result (n + V + 5 bytes a codeword) and the table; a window of 32
// edges is 15 (parity) or 20 (count) SASS instructions, three loads and
// integer ones, which an H100 SM runs at 64 lanes a clock, two warp
// instructions (chip_smoke.py counts them and turns them into floors;
// PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // ops/cuda_bf.THREADS

// The 32-bit window of entry `ent` (ops/cuda_bf.window_table): b | w0 << 5 |
// w1 << 18, the 32 bits from bit b of word w0 of `src` on, continued in word
// w1 (the next word of the window's segment, which wraps).
__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ src, int ent) {
  return __funnelshift_r(src[(ent >> 5) & 0x1fff], src[ent >> 18], ent);
}

// bit 0 of each byte of x, gathered into 4 bits (byte k -> bit k)
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// 4 bits spread into the bit 0 of 4 bytes (bit k -> byte k)
__device__ __forceinline__ uint32_t unpack4(uint32_t h) {
  return (h * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads, 4) bitflip_kernel(
    const uint8_t* __restrict__ hard,  // (B, n) hard bits 0/1, 16-byte aligned
    uint8_t* __restrict__ bits_out,    // (B, V) out
    uint8_t* __restrict__ success,     // (B,) out: 0/1
    int32_t* __restrict__ iterations,  // (B,) out
    const int* __restrict__ table,     // row_off (R+1), col_off (Cc+1), fwd, inv (sumA*W each)
    int* __restrict__ next,            // the codewords handed out after the first wave; 0
    int table_len, int vote, int vote_row, int B, int n, int M, int R, int Cc, int maxiters,
    int lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  int* tab = reinterpret_cast<int*>(smem);
  for (int k = threadIdx.x; k < table_len; k += blockDim.x) tab[k] = table[k];
  __syncthreads();  // the only CTA barrier: the table is read-only from here
  const int W = M >= 32 ? M >> 5 : 1;  // words a block column or row
  const int wsh = __ffs(W) - 1;
  const int RW = R * W, CW = Cc * W;
  const int* row_off = tab;
  const int* col_off = row_off + R + 1;
  const int* fwd = col_off + Cc + 1;      // by row, W an addend: windows of the bits
  const int* inv = fwd + row_off[R] * W;  // by column: windows of the parities
  const int gsh = __ffs(lanes) - 1;
  const int per_cta = blockDim.x >> gsh;
  const int g = threadIdx.x >> gsh;  // this lane's codeword slot in the CTA
  const int lg = threadIdx.x & (lanes - 1);
  const int leader = (threadIdx.x & 31) & ~(lanes - 1);
  const unsigned gmask = lanes == 32 ? kFull : ((1u << lanes) - 1) << leader;
  uint32_t* bits = smem + table_len + g * (4 * CW + RW);
  uint32_t* par = bits + CW;
  uint32_t* c0 = par + RW;
  uint32_t* c1 = c0 + CW;
  uint32_t* c2 = c1 + CW;
  const int V = Cc * M;

  // persistent: the first wave takes codewords in slot order, then a slot
  // that is done takes the next one not yet handed out
  for (int b = blockIdx.x * per_cta + g;;) {
    const bool has = b < B;
    if (!__any_sync(kFull, has)) break;  // no codeword left for this warp

    // pack: 16 bytes a lane into 16 bits; TC128's 16-bit column twice a word
    const int chunks = has ? n >> 4 : 0;
    const uint4* in = reinterpret_cast<const uint4*>(hard + static_cast<size_t>(b) * n);
    for (int u = lg; u < chunks; u += lanes) {
      const uint4 v = __ldg(in + u);
      const uint32_t h = pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
      if (M == 16) {
        bits[u] = h | h << 16;
      } else {
        reinterpret_cast<uint16_t*>(bits)[u] = static_cast<uint16_t>(h);
      }
    }
    const int filled = M == 16 ? chunks : chunks >> 1;  // words that hold input bits
    for (int w = filled + lg; has && w < CW; w += lanes) bits[w] = 0;  // punctured tail = 0
    __syncwarp();

    if (maxiters > 0 && vote >= 0) {  // uniform: the erasure vote of a punctured code
      for (int w = has ? lg : W; w < W; w += lanes) {
        uint32_t p = 0;
#pragma unroll 1
        for (int e = row_off[vote_row] * W + w; e < row_off[vote_row + 1] * W; e += W) {
          p ^= window(bits, fwd[e]);
        }
        par[vote_row * W + w] = p;
      }
      __syncwarp();
      for (int w = has ? lg : W; w < W; w += lanes) {
        bits[(Cc - 1) * W + w] = window(par, inv[vote * W + w]);
      }
      __syncwarp();
    }

    bool active = has;  // not yet converged
    int converged = 0;
    int it_done = maxiters;
    for (int it = 0; it < maxiters; ++it) {
      if (!__any_sync(kFull, active)) break;  // every codeword of the warp is done
      uint32_t any = 0;
      for (int pw = active ? lg : RW; pw < RW; pw += lanes) {
        const int r = pw >> wsh;
        uint32_t p = 0;
#pragma unroll 1  // a window a loop body, which chip_smoke.py counts; unrolled is no faster
        for (int e = row_off[r] * W + (pw & (W - 1)); e < row_off[r + 1] * W; e += W) {
          p ^= window(bits, fwd[e]);
        }
        par[pw] = p;
        any |= p;
      }
      const bool unsat = __ballot_sync(kFull, any != 0) & gmask;
      if (active && !unsat) {
        converged = 1;
        it_done = it;
        active = false;
      }
      __syncwarp();
      // counts, and the ORs the bit-sliced maximum needs: a2 = OR c2; a1[m2]
      // = OR of c1 where c2 == m2; a0[2*m2 + m1] = OR of c0 where (c2, c1) ==
      // (m2, m1)
      uint32_t a2 = 0, a1[2] = {0, 0}, a0[4] = {0, 0, 0, 0};
      for (int vw = active ? lg : CW; vw < CW; vw += lanes) {
        const int c = vw >> wsh;
        uint32_t p0 = 0, p1 = 0, p2 = 0;
#pragma unroll 1
        for (int e = col_off[c] * W + (vw & (W - 1)); e < col_off[c + 1] * W; e += W) {
          const uint32_t x = window(par, inv[e]);
          const uint32_t k0 = p0 & x;
          p0 ^= x;
          p2 |= p1 & k0;
          p1 ^= k0;
        }
        c0[vw] = p0;
        c1[vw] = p1;
        c2[vw] = p2;
        a2 |= p2;
        a1[1] |= p2 & p1;
        a1[0] |= ~p2 & p1;
        a0[3] |= p2 & p1 & p0;
        a0[2] |= p2 & ~p1 & p0;
        a0[1] |= ~p2 & p1 & p0;
        a0[0] |= ~p2 & ~p1 & p0;
      }
      const bool m2 = __ballot_sync(kFull, a2 != 0) & gmask;
      const bool m1 = __ballot_sync(kFull, (m2 ? a1[1] : a1[0]) != 0) & gmask;
      const uint32_t a0s = m2 ? (m1 ? a0[3] : a0[2]) : (m1 ? a0[1] : a0[0]);
      const bool m0 = __ballot_sync(kFull, a0s != 0) & gmask;
      // flip every variable whose count equals the maximum (> 0: a parity is set)
      for (int vw = active ? lg : CW; vw < CW; vw += lanes) {
        const uint32_t eq = (m2 ? c2[vw] : ~c2[vw]) & (m1 ? c1[vw] : ~c1[vw]) &
                            (m0 ? c0[vw] : ~c0[vw]);
        bits[vw] ^= eq;
      }
      __syncwarp();
    }

    // unpack: 16 bits a lane into 16 bytes
    uint4* out = reinterpret_cast<uint4*>(bits_out + static_cast<size_t>(b) * V);
    for (int u = has ? lg : V >> 4; u < V >> 4; u += lanes) {
      const uint32_t h = M == 16 ? bits[u] & 0xffffu : reinterpret_cast<const uint16_t*>(bits)[u];
      out[u] = make_uint4(unpack4(h & 15), unpack4((h >> 4) & 15), unpack4((h >> 8) & 15),
                          unpack4(h >> 12));
    }
    int nb = B;
    if (has && lg == 0) {
      success[b] = static_cast<uint8_t>(converged);
      iterations[b] = it_done;
      nb = gridDim.x * per_cta + atomicAdd(next, 1);
    }
    b = __shfl_sync(kFull, nb, leader);
    __syncwarp();  // the unpack's reads precede the next codeword's packing
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// threads, lanes and smem are ops/cuda_bf.launch_config's; `grid` CTAs (at
// most those resident on the card) decode all B codewords, handed out
// through the counter `next`, which this sets to 0 on the stream first.
extern "C" int bitflip_u8(
    const uint8_t* hard, uint8_t* bits, uint8_t* success, int32_t* iterations,
    const int* table, int* next, int table_len, int vote, int vote_row, int B, int n, int M,
    int R, int Cc, int maxiters, int threads, int lanes, int smem, int grid, void* stream) {
  if (threads != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(bitflip_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitflip_kernel<<<grid, threads, smem, s>>>(hard, bits, success, iterations, table, next,
                                              table_len, vote, vote_row, B, n, M, R, Cc,
                                              maxiters, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of `threads` threads and `smem` dynamic shared bytes that fit on
// one SM of the current card, as the occupancy calculator reports them.
extern "C" int bitflip_u8_ctas_per_sm(int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(bitflip_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, bitflip_kernel, threads, smem));
}
