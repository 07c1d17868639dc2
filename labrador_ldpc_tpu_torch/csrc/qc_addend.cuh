// The QC addends of the port's min-sum and sum-product kernels, as packed
// descriptors.
//
// An addend links check row*M + i of block row `row` to variable col*M +
// perm(i) of block column `col` (codes/expand.py BlockPerm): a rotation,
// perm(i) = (i + shift) mod M (HI | shift), or a pi permutation, perm(i) =
// q*((theta + j) mod 4) + (phi[j] + i) mod q with q = M/4, j = i/q (HP | K).
// M is a power of two and a multiple of 4, so every reduction mod M or M/4 is
// a mask.
//
// The descriptors are `ops/cuda_layered.addend_descriptors`: two packed int32
// words per addend, which the layered kernels (min-sum and sum-product) hold
// in registers (Table) and unpack (Addend); the flooding min-sum kernel
// unpacks them once per codeword, from device memory, into its table of each
// edge's variable. (The bit-flip kernel reads 32-bit windows of packed
// blocks instead: ops/cuda_bf.window_descriptors.)
#pragma once

namespace qc {

constexpr int kMaxAddends = 64;  // two per lane of the register-held Table
constexpr int kMaxCols = 16;     // block columns: four bits of a descriptor

// One addend, unpacked from its descriptor: lo = col | kind << 4 | theta << 5
// | s0 << 7 | run_end << 19, with s0 the rotation's shift or a pi
// permutation's phi0, and run_end the end of the run of addends this one
// belongs to (a layer's pass 2 needs no barrier inside a run); hi = phi1 |
// phi2 << 10 | phi3 << 20.
struct Addend {
  int lo, hi;
  __device__ __forceinline__ int col() const { return lo & 15; }
  __device__ __forceinline__ int run_end() const { return (lo >> 19) & 63; }
  // variable offset (within block column col()) of check offset i;
  // qsh = log2(M / 4)
  __device__ __forceinline__ int perm(int i, int M, int qsh) const {
    const int s0 = (lo >> 7) & 4095;
    if (!(lo & 16)) return (i + s0) & (M - 1);
    const int j = i >> qsh;
    const int phi = j == 0 ? s0 : (hi >> (10 * (j - 1))) & 1023;
    return ((((lo >> 5) + j) & 3) << qsh) | ((phi + i) & ((1 << qsh) - 1));
  }
};

// The descriptors in registers: lane l holds those of addends l and l + 32;
// every lane of the warp must call fetch with the same e.
struct Table {
  int lo[2], hi[2];
  // lane l of the calling warp loads its two descriptors from desc (sumA, 2)
  __device__ __forceinline__ void load(const int* __restrict__ desc, int sumA) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = (threadIdx.x & 31) + 32 * h;
      lo[h] = e < sumA ? desc[2 * e] : 0;
      hi[h] = e < sumA ? desc[2 * e + 1] : 0;
    }
  }
  __device__ __forceinline__ Addend fetch(int e) const {
    const bool upper = e >= 32;
    const int l = __shfl_sync(0xffffffffu, upper ? lo[1] : lo[0], e & 31);
    // hi holds phi1..phi3, which only a pi permutation reads (a uniform branch)
    const int h = (l & 16) ? __shfl_sync(0xffffffffu, upper ? hi[1] : hi[0], e & 31) : 0;
    return Addend{l, h};
  }
};

}  // namespace qc
