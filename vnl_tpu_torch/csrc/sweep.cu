// Kernel C: batched inverse of symmetric positive-definite matrices by the
// symmetric sweep (Gauss-Jordan without pivoting), one thread block per
// matrix.
//
// Replaces the TPU kernel vnl_tpu/ops/pallas_linalg.py::_sweep_kernel
// together with its wrapper inv_spd_lanes: Jacobi scaling by
// rsqrt(diag), the n sweep steps, the sign, the unscaling and the
// symmetrisation 0.5 (X + X^T) all happen inside this one launch.
//
// The sweep: for k = 0..n-1, with the k-th column and row taken BEFORE the
// update (the update is not bitwise symmetric, so both are kept),
//     v = A[:,k] - e_k,  w = (A[k,:] - e_k) / A[k,k],
//     A <- A - v w^T,    A[k,k] <- A[k,k] - 2,
// after which A holds -A^-1.
//
// What bounds it on an H100: a matrix is read once and written once
// (2 * 4 n^2 bytes) and costs 2 n^3 fp32 operations outside the tensor
// cores; for the physics' 2048 matrices of n = 73 both limits are a few
// tens of microseconds.  The real cost is the n dependent rank-1 updates,
// each ended by a block-wide barrier, so the design keeps that chain short:
// the matrix lives in shared memory (n odd or even, rows are walked with
// unit stride, columns with stride n), the threads form a 32-wide 2-D
// layout (no integer division per entry), and the threads that update row
// k+1 and column k+1 also write them into the next pivot's snapshot
// buffers, so a pivot costs ONE barrier and one reciprocal per thread.
// All arithmetic is fp32; the kernel allocates nothing and runs on the
// caller's stream.

#include <cuda_runtime.h>

__global__ void sweep_kernel(const float* __restrict__ a,
                             float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  float* A = smem;              // (n, n), Jacobi-scaled, swept in place
  float* scl = A + n * n;       // (n) rsqrt of the diagonal
  float* snap = scl + n;        // 2 buffers x (column (n), row (n))

  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid & 31, ty = tid >> 5, nwarp = nt >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;

  for (int i = tid; i < n * n; i += nt) A[i] = a[base + i];
  __syncthreads();
  for (int i = tid; i < n; i += nt) scl[i] = rsqrtf(A[i * n + i]);
  __syncthreads();
  for (int r = ty; r < n; r += nwarp)
    for (int s = tx; s < n; s += 32) A[r * n + s] *= scl[r] * scl[s];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {   // snapshot of pivot 0
    snap[i] = A[i * n];
    snap[n + i] = A[i];
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float* col = snap + (k & 1) * 2 * n;
    const float* row = col + n;
    float* ncol = snap + ((k + 1) & 1) * 2 * n;
    float* nrow = ncol + n;
    const float dinv = 1.0f / row[k];
    for (int r = ty; r < n; r += nwarp) {
      const float v = col[r] - (r == k ? 1.0f : 0.0f);
      for (int s = tx; s < n; s += 32) {
        const float w = (row[s] - (s == k ? 1.0f : 0.0f)) * dinv;
        float x = A[r * n + s] - v * w;
        if (r == k && s == k) x -= 2.0f;  // the rank-1 form over-counts by 2
        A[r * n + s] = x;
        if (s == k + 1) ncol[r] = x;
        if (r == k + 1) nrow[s] = x;
      }
    }
    __syncthreads();
  }

  // A = -(scaled inverse): sign, unscale, symmetrise
  for (int r = ty; r < n; r += nwarp)
    for (int s = tx; s < n; s += 32)
      out[base + r * n + s] =
          -0.5f * (A[r * n + s] + A[s * n + r]) * (scl[r] * scl[s]);
}

extern "C" size_t sweep_smem_bytes(int n) {
  return ((size_t)n * n + 5 * (size_t)n) * sizeof(float);
}

extern "C" int sweep_launch(const float* a, float* out, int batch, int n,
                            int threads, void* stream) {
  const size_t smem = sweep_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}
