// Batched systematic GF(2) encoder for Hopper (sm_90a), bit-packed on the
// CUDA cores: (B, k) data bits in, the whole (B, n) codeword out, one launch.
//
// The JAX package leaves this product to XLA (labrador_ldpc_tpu/ops/
// encoder.py); the plain version, the same function bit for bit, is
// labrador_ldpc_tpu_torch/ops/encoder.py encode_bits_plain (a float32
// matmul). The launch shape and the packed generator come from
// ops/cuda_encoder.py (launch_config, packed_generator).
//
// Parity bit j of a codeword is popc(XOR over w of d_w & g_jw) & 1, where
// d_w holds data bits 32w..32w+31 (bit b of the word is data bit 32w + b, bit
// 0 of the input byte) and g_jw the same bits of column j of the generator's
// parity block. So one LOP3 (acc ^= d & g) does 32 bit-products and their
// sum mod 2, and one popc a parity bit ends it.
//
// Design, a GEMM tiled for that product:
//   * a CTA of 256 threads takes BM codewords (blockIdx.y) and `tiles` tiles
//     of BN parity columns (blockIdx.x is its group of tiles); BM x BN is
//     128 x 128 where k is 512 bits or more, 256 x 64 (deep codeword tiles)
//     for the shorter TC codes, whose k a square tile's 16-word stage would
//     pad with zero words;
//   * its prologue packs the BM codewords' data bits, all of k, into shared
//     memory (word w of codeword m at sA[w * (BM + 4) + m]), reading 32
//     bytes a thread with two 16-byte loads, 8 such pairs in flight; the
//     CTAs of group 0 also store those bytes as the codewords' systematic
//     head, so the output is written once;
//   * the packed generator ((k words rounded up to a stage) x (n - k rounded
//     up to BN), zero padded, 2 MiB at TM8192, resident in L2) is staged
//     through shared memory BN / 8 words of k at a time (16 for the square
//     tiles, 8 for the deep ones) in a ring of three stages filled by
//     cp.async two stages ahead of the product, one CTA barrier a stage;
//   * each thread keeps 8 x 8 XOR accumulators in registers: codewords ty*4
//     + {0..3} and BM/2 + ty*4 + {0..3}, columns tx*4 + {0..3} and BN/2 +
//     tx*4 + {0..3}, each group of four one 128-bit shared load a word of k:
//     64 LOP3 for 4 loads;
//   * after the tile's last stage the thread takes popc & 1 of each
//     accumulator and stores four parity bytes at a time.
// Ragged edges: codewords past B are packed as zeros and never stored;
// columns past n - k (zero generator columns) are never stored.
//
// What bounds it: the SM's integer pipe, 64 lanes a clock, which runs the
// LOP3s (k/32 * (n - k) a codeword; 4.3 G at TM8192, B = 8,192), where the
// bytes (k in, n out a codeword) take less time; for the short TC codes the
// bytes bound it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 3;      // generator stages in shared memory (ops/cuda_encoder.STAGES)
constexpr int kBatch = 8;       // 32-byte loads a thread has in flight in the prologue
constexpr int kTM = 8;          // codewords a thread
constexpr int kTN = 8;          // parity columns a thread

// bit 0 of each byte of x, gathered into 4 bits (byte i -> bit i)
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
}

// popc & 1 of four accumulators as four bytes, the first in the lowest
__device__ __forceinline__ uint32_t parity4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return (__popc(a) & 1) | (__popc(b) & 1) << 8 | (__popc(c) & 1) << 16 |
         static_cast<uint32_t>(__popc(d) & 1) << 24;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), 2) encoder_kernel(
    const uint8_t* __restrict__ data,  // (B, k) bits, bit 0 of each byte; 16-byte aligned
    const uint32_t* __restrict__ gen,  // (kw_pad, nk_pad) packed generator parity block
    uint8_t* __restrict__ out,         // (B, k + nk) codewords; 16-byte aligned
    int B, int k, int nk, int kw_pad, int nk_pad, int tiles) {
  constexpr int kThreads = (BM / kTM) * (BN / kTN);
  constexpr int kTX = BN / kTN;  // threads along the columns
  constexpr int kLda = BM + 4;   // a word of k, padded: 16-byte aligned rows
  constexpr int kStageWords = BN / 8;  // words of k a generator stage: 16 square, 8 deep
  constexpr int kStage = kStageWords * BN;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sA = smem;                 // kw_pad x kLda packed data words
  uint32_t* sB = sA + kw_pad * kLda;  // kStages stages of kStageWords x BN generator words

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int m0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * tiles * BN;  // the group's first parity column
  const int n = k + nk;
  const int kw = k >> 5;
  const int chunks = kw_pad / kStageWords;
  const int steps = tiles * chunks;

  // the generator's stages in order, (tile, chunk) = (0, 0), (0, 1), ...:
  // each stage one cp.async group (an empty one past the last), so that
  // "all but the newest group done" means the stage about to be read is in
  int ld_chunk = 0, ld_col = col0, ld_buf = 0, ld_left = steps;
  auto stage = [&]() {
    if (ld_left > 0) {
      const uint32_t* src =
          gen + static_cast<size_t>(ld_chunk * kStageWords) * nk_pad + ld_col;
      uint32_t* dst = sB + ld_buf * kStage;
#pragma unroll
      for (int u = 0; u < (kStage / 4 + kThreads - 1) / kThreads; ++u) {
        const int i = tid + u * kThreads;  // the stage's 16-byte piece
        const int w = i / (BN / 4), x = (i % (BN / 4)) * 4;
        if (kStage / 4 % kThreads == 0 || i < kStage / 4) {
          cp_async16(dst + w * BN + x, src + static_cast<size_t>(w) * nk_pad + x);
        }
      }
      --ld_left;
      if (++ld_chunk == chunks) {
        ld_chunk = 0;
        ld_col += BN;
      }
      ld_buf = ld_buf == kStages - 1 ? 0 : ld_buf + 1;
    }
    cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) stage();

  // prologue: pack the codewords' data bits, kBatch 32-byte loads a thread
  // in flight; group 0 stores the systematic head. kw_pad divides the
  // threads, so a thread packs one word pw of every (threads / kw_pad)-th
  // codeword
  const int pw = tid % kw_pad, m_step = kThreads / kw_pad;
  for (int m_base = tid / kw_pad; m_base < BM; m_base += kBatch * m_step) {
    uint4 v[2 * kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m_base + u * m_step, row = m0 + m;
      if (m < BM && row < B && pw < kw) {
        const uint4* src =
            reinterpret_cast<const uint4*>(data + static_cast<size_t>(row) * k) + 2 * pw;
        v[2 * u] = __ldg(src);
        v[2 * u + 1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m_base + u * m_step, row = m0 + m;
      if (m >= BM) break;
      uint32_t word = 0;
      if (row < B && pw < kw) {
        word = pack16(v[2 * u]) | pack16(v[2 * u + 1]) << 16;
        if (blockIdx.x == 0) {
          uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n) + 2 * pw;
          dst[0] = v[2 * u];
          dst[1] = v[2 * u + 1];
        }
      }
      sA[pw * kLda + m] = word;
    }
  }

  uint32_t acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
  }

  int chunk = 0, col = col0 + tx * 4, buf = 0;
  for (int q = 0; q < steps; ++q) {
    cp_async_wait<kStages - 2>();
    // stage q, and before the first the packed data, are in shared memory;
    // every thread is done with stage q - 1, whose buffer the next load takes
    __syncthreads();
    stage();
    const uint32_t* a = sA + chunk * kStageWords * kLda + ty * 4;
    const uint32_t* b = sB + buf * kStage + tx * 4;
#pragma unroll
    for (int w = 0; w < kStageWords; ++w) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(a + w * kLda);
      const uint4 a1 = *reinterpret_cast<const uint4*>(a + w * kLda + BM / 2);
      const uint4 b0 = *reinterpret_cast<const uint4*>(b + w * BN);
      const uint4 b1 = *reinterpret_cast<const uint4*>(b + w * BN + BN / 2);
      const uint32_t av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] ^= av[i] & bv[j];
      }
    }
    buf = buf == kStages - 1 ? 0 : buf + 1;
    if (++chunk < chunks) continue;

    // the tile's last stage: store its parity bits
    chunk = 0;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
      uint8_t* dst = out + static_cast<size_t>(row) * n + k + col;
      if (row < B && col < nk) {
        *reinterpret_cast<uint32_t*>(dst) = parity4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      if (row < B && col + BN / 2 < nk) {
        *reinterpret_cast<uint32_t*>(dst + BN / 2) =
            parity4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
    }
    col += BN;
  }
}

template <int BM, int BN>
int launch(const uint8_t* data, const uint32_t* gen, uint8_t* out, int B, int k, int nk,
           int kw_pad, int nk_pad, int tiles, int threads, int smem, int groups, int row_tiles,
           cudaStream_t s) {
  if (threads != (BM / kTM) * (BN / kTN) || kw_pad % (BN / 8) || threads % kw_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(encoder_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  encoder_kernel<BM, BN><<<dim3(groups, row_tiles), threads, smem, s>>>(
      data, gen, out, B, k, nk, kw_pad, nk_pad, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch. bm,
// bn, threads, smem, groups, row_tiles and tiles (a group's) are
// ops/cuda_encoder.launch_config's; gen is its packed generator, kw_pad x
// nk_pad words.
extern "C" int encoder_u8(const uint8_t* data, const uint32_t* gen, uint8_t* out, int B, int k,
                          int nk, int kw_pad, int nk_pad, int bm, int bn, int tiles,
                          int threads, int smem, int groups, int row_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) {
    return launch<128, 128>(data, gen, out, B, k, nk, kw_pad, nk_pad, tiles, threads, smem,
                                groups, row_tiles, s);
  }
  if (bm == 256 && bn == 64) {
    return launch<256, 64>(data, gen, out, B, k, nk, kw_pad, nk_pad, tiles, threads, smem,
                              groups, row_tiles, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
