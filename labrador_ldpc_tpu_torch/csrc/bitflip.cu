// Gallager bit-flip LDPC decoder with the punctured-tail erasure pass, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, both pinned bit-exact to the
// XLA twin labrador_ldpc_tpu/ops/bitflip.py:269 make_bf_decoder_qc:
//   * labrador_ldpc_tpu/ops/pallas_bf.py:53 make_bf_decoder_pallas
//     (lane-major, M >= 512: TM2048/5120/6144/8192), and
//   * labrador_ldpc_tpu/ops/pallas_tc.py:741 make_bf_decoder_pallas_tc
//     (node-major, M <= 256: TC128/256/512, TM1280/1536).
// One kernel covers all nine codes through the per-addend QC table of
// qc_addend.cuh (the table of ops/cuda_layered.addend_table). The plain
// version, bit for bit the same function, is
// labrador_ldpc_tpu_torch/ops/bitflip.py bitflip_plain.
//
// Design. One CTA decodes one codeword (grid = B). Its whole state fits in
// shared memory as bytes: the V hard bits, the V violation counts and the
// R*M check parities (TM8192: 10,240 + 10,240 + 6,144 = 26,624 B), so
// nothing but the input and the result touches device memory. Per iteration:
//   1. parity of every check: XOR over its row's addends (perm_index);
//   2. violation count of every variable: the sum, over the addends of its
//      block column, of the parity of the check that the addend links to it
//      (perm_inverse). Two addends of one row on one column (the I+Pi sums)
//      count twice, as the twin's one inverse scatter per addend does. A
//      gather, so no atomics: the counts are integers and exact in any order;
//   3. the codeword's maximum count: a warp reduction, then one shared-memory
//      atomicMax per warp;
//   4. maximum 0: converged at this iteration (the twin takes `ok` from the
//      counts before any flip); else flip every variable at the maximum.
// The early exit is per codeword and uniform across the CTA (every thread
// reads the same maximum), in place of the TPU kernels' per-tile while_loop.
//
// Punctured codes start with one erasure voting pass, only when maxiters > 0
// (with maxiters == 0 the twin runs none). The erased set is the last block
// column (the wrapper checks punctured_bits == M and n == (Cc-1)*M), so a
// check's number of erased neighbours is the number of its row's addends on
// that column: the wrapper passes the addends of the rows that have exactly
// one (`vote_edges`), and only their checks vote, +1 on parity 1 and -1 on
// parity 0 (the tail is 0, so the parity of all bits is the parity of the
// non-erased ones). Erased bits with a positive total become 1.
//
// What bounds it: integer operations and shared-memory latency, not bytes.
// Input and output are n + V + 5 bytes per codeword; each iteration does
// about 8 integer operations per edge (index, address, load, xor/add) and a
// few per variable, all on shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "qc_addend.cuh"

namespace {

using qc::kTableCols;
using qc::perm_index;
using qc::perm_inverse;

// par[r*M + i] = XOR of the bits that the addends of row r link to check i
__device__ __forceinline__ void check_parity(const uint8_t* bits, uint8_t* par,
                                             const int* __restrict__ table,
                                             const int* __restrict__ row_off, int R, int M) {
  for (int c = threadIdx.x; c < R * M; c += blockDim.x) {
    const int r = c / M, i = c - r * M;
    uint8_t p = 0;
    for (int e = row_off[r]; e < row_off[r + 1]; ++e) {
      const int* a = table + e * kTableCols;
      p ^= bits[a[1] * M + perm_index(a, i, M)];
    }
    par[c] = p;
  }
}

__global__ void bitflip_kernel(
    const uint8_t* __restrict__ hard,       // (B, n) hard bits 0/1
    uint8_t* __restrict__ bits_out,         // (B, V) out
    uint8_t* __restrict__ success,          // (B,) out: 0/1
    int32_t* __restrict__ iterations,       // (B,) out
    const int* __restrict__ table,          // (sumA, 9)
    const int* __restrict__ row_off,        // (R + 1,) first addend of each block row
    const int* __restrict__ col_edges,      // (sumA,) addend indices grouped by block column
    const int* __restrict__ col_off,        // (Cc + 1,) first entry of each column in col_edges
    const int* __restrict__ vote_edges,     // (n_vote,) addends whose checks vote on erasures
    int n_vote, int n, int M, int R, int Cc, int maxiters) {
  extern __shared__ uint8_t smem[];
  __shared__ int mx_s;
  const int V = Cc * M;
  uint8_t* bits = smem;       // (V,) working hard bits
  uint8_t* viol = bits + V;   // (V,) violation counts (at most the column's addends)
  uint8_t* par = viol + V;    // (R * M,) check parities

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint8_t* in = hard + static_cast<size_t>(b) * n;
  for (int v = tid; v < V; v += nt) bits[v] = v < n ? in[v] : 0;  // punctured tail = 0
  __syncthreads();

  if (maxiters > 0 && n_vote > 0) {
    check_parity(bits, par, table, row_off, R, M);
    __syncthreads();
    const int ecol = Cc - 1;  // the erased block column
    for (int o = tid; o < M; o += nt) {
      int vote = 0;
      for (int k = 0; k < n_vote; ++k) {
        const int* a = table + vote_edges[k] * kTableCols;
        vote += par[a[0] * M + perm_inverse(a, o, M)] ? 1 : -1;
      }
      if (vote > 0) bits[ecol * M + o] = 1;
    }
    __syncthreads();
  }

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
    if (tid == 0) mx_s = 0;  // every read of the last maximum precedes the last barrier
    check_parity(bits, par, table, row_off, R, M);
    __syncthreads();
    int mx = 0;
    for (int v = tid; v < V; v += nt) {
      const int c = v / M, o = v - c * M;
      int cnt = 0;
      for (int k = col_off[c]; k < col_off[c + 1]; ++k) {
        const int* a = table + col_edges[k] * kTableCols;
        cnt += par[a[0] * M + perm_inverse(a, o, M)];
      }
      viol[v] = static_cast<uint8_t>(cnt);
      mx = max(mx, cnt);
    }
    mx = __reduce_max_sync(0xffffffffu, mx);
    if ((tid & 31) == 0) atomicMax(&mx_s, mx);
    __syncthreads();
    const int m = mx_s;
    if (m == 0) {  // uniform across the block
      converged = 1;
      it_done = it;
      break;
    }
    for (int v = tid; v < V; v += nt) {
      if (viol[v] == m) bits[v] ^= 1;
    }
    __syncthreads();
  }

  uint8_t* out = bits_out + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += nt) out[v] = bits[v];
  if (tid == 0) {
    success[b] = static_cast<uint8_t>(converged);
    iterations[b] = it_done;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
extern "C" int bitflip_u8(
    const uint8_t* hard, uint8_t* bits, uint8_t* success, int32_t* iterations,
    const int* table, const int* row_off, const int* col_edges, const int* col_off,
    const int* vote_edges, int n_vote, int B, int n, int M, int R, int Cc, int maxiters,
    void* stream) {
  const int V = Cc * M;
  int threads = V < 256 ? V : 256;
  threads = (threads + 31) / 32 * 32;  // whole warps: the max reduction uses full masks
  const size_t smem = 2 * static_cast<size_t>(V) + static_cast<size_t>(R) * M;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bitflip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bitflip_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      hard, bits, success, iterations, table, row_off, col_edges, col_off, vote_edges, n_vote,
      n, M, R, Cc, maxiters);
  return static_cast<int>(cudaGetLastError());
}
