// The one-warp symmetric sweep of kernels A (position.cu,
// position_warp_kernel) and C (sweep.cu, sweep_warp_kernel), for n <= 32.
//
// Lane s holds column s of a Jacobi-scaled n x n matrix in T registers
// (zeros beyond n).  For pivot k, with column and row k as they were
// before the update,
//   v = A[:,k] - e_k,  w = (A[k,:] - e_k) / A[k,k],
//   A <- A - v w^T,    A[k,k] <- A[k,k] - 2,
// the column entries (r, k) come by shuffles from lane k and the pivot-row
// entry (k, s) is the lane's own register k: no barrier, and the matrix
// never passes through shared memory.  The loop runs over all T rows,
// padding included, so that it unrolls and every row index is a constant;
// pivots k >= npiv are skipped by a branch uniform over the warp.  After
// npiv = n pivots x holds -A^-1 (npiv = 0 leaves x as it was: profiling).

#pragma once

template <int T>
__device__ __forceinline__ void warp_sweep(float (&x)[T], int npiv,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    if (k < npiv) {
      const float dinv = 1.0f / __shfl_sync(0xffffffffu, x[k], k);
      const float w = (lane == k ? x[k] - 1.0f : x[k]) * dinv;
#pragma unroll
      for (int r = 0; r < T; ++r) {
        float v = __shfl_sync(0xffffffffu, x[r], k);
        if (r == k) v -= 1.0f;
        x[r] -= v * w;
      }
      if (lane == k) x[k] -= 2.0f;   // the rank-1 form over-counts it by 2
    }
  }
}
