// Index arithmetic of the per-addend QC table shared by the port's kernels.
//
// The table is `ops/cuda_layered.addend_table(qc_structure(code))`: one int32
// row of kTableCols per addend, (row, col, kind, shift, theta, phi0..phi3).
// Addend e links check row*M + i to variable col*M + perm_index(a, i, M)
// (codes/expand.py BlockPerm). M must be a power of two and a multiple of 4:
// every reduction mod M or M/4 is a mask.
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

}  // namespace qc
