// Index arithmetic of the QC addends shared by the port's kernels, in two
// forms.
//
// The table is `ops/cuda_layered.addend_table(qc_structure(code))`: one int32
// row of kTableCols per addend, (row, col, kind, shift, theta, phi0..phi3),
// read from device memory (the bit-flip kernel). Addend e links
// check row*M + i to variable col*M + perm_index(a, i, M) (codes/expand.py
// BlockPerm). M must be a power of two and a multiple of 4: every reduction
// mod M or M/4 is a mask.
//
// The descriptors are `ops/cuda_layered.addend_descriptors`: two packed int32
// words per addend, which the layered kernels (min-sum and sum-product) hold
// in registers (Table) and unpack (Addend); the flooding min-sum kernel
// unpacks them once per codeword, from device memory, into its table of each
// edge's variable.
#pragma once

namespace qc {

constexpr int kTableCols = 9;  // row, col, kind, shift, theta, phi0..phi3
constexpr int kKindRot = 0;    // perm(i) = (i + shift) mod M             (HI | shift)
                               // kind 1: perm(i) = q*((theta + j) mod 4)
                               //         + (phi[j] + i) mod q, q = M/4, j = i/q  (HP | K)

// variable offset (within block column a[1]) of check offset i of addend a
__device__ __forceinline__ int perm_index(const int* __restrict__ a, int i, int M) {
  if (a[2] == kKindRot) return (i + a[3]) & (M - 1);
  const int q = M >> 2;
  const int j = i / q;
  return ((a[4] + j) & 3) * q + ((a[5 + j] + i) & (q - 1));
}

// check offset (within block row a[0]) whose addend a reaches variable
// offset v: the inverse of perm_index
__device__ __forceinline__ int perm_inverse(const int* __restrict__ a, int v, int M) {
  if (a[2] == kKindRot) return (v - a[3]) & (M - 1);
  const int q = M >> 2;
  const int j = ((v / q) - a[4]) & 3;  // source quarter on the check side
  return j * q + ((v - a[5 + j]) & (q - 1));
}

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
