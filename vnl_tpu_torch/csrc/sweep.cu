// Kernel C: batched inverse of symmetric positive-definite matrices by the
// symmetric sweep (Gauss-Jordan without pivoting).
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
// after which A holds -A^-1.  Two pivots K = {k, k+1} at once are the same
// step with the 2 x 2 pivot block P = A[K,K]:
//     V = A[:,K] - E_K,  W = P^-1 (A[K,:] - E_K^T),
//     A <- A - V W,      A[k,k], A[k+1,k+1] each <- themselves - 2,
// which equals the two single steps up to rounding.
//
// What bounds it on an H100: a matrix is read once and written once
// (2 * 4 n^2 bytes) and costs 2 n^3 fp32 operations outside the tensor
// cores; for the physics' 2048 matrices of n = 73 both limits are a few
// tens of microseconds.  The real cost is the chain of n dependent updates,
// each ended by a barrier, and the instructions every entry spends on it.
//
// Three routes, chosen by n alone (ops/sweep.py route):
//  * The one-warp route, n <= 32 (sweep_warp_kernel<T>, T = 16 or 32).
//    One warp sweeps one matrix and lane s holds column s in T registers.
//    For pivot k the column comes by shuffles from lane k and the
//    pivot-row entry is the lane's own register k: no barrier, and the
//    matrix never passes through shared memory.  The loop is kernel A's
//    (warp_sweep.cuh).  kWarpMats = 4 warps, four independent matrices,
//    share a block.  Below 33 the register tiles were mostly padding,
//    8 warps (256 threads) for the ant's 196 entries, with a barrier
//    every two pivots.
//  * The register route, 32 < n <= 96 (sweep_tile_kernel).  A block sweeps two
//    matrices (matrices 2b and 2b+1 of the flat batch), each with its own
//    kWarps = 8 warps.  Thread (warp, lane) of a matrix owns the entries
//    (r, s) = (row(warp, i), lane + 32 j), i < TR, j < TC, in registers for
//    all pivots; TR and TC are template constants, so the tile unrolls and
//    no entry pays index arithmetic.  row(warp, i) keeps the pair of rows
//    (2 m, 2 m + 1), m = warp + 8 (i / 2), in one warp.  The pivot columns
//    of my rows lie in my own warp, in lanes k % 32 and k % 32 + 1 of tile
//    column k / 32: 2 TR shuffles bring them.  The pairs are walked in
//    groups of 8, the 16 rows of two tile rows of the 8 warps, so that the
//    tile row and column of every pivot are constants of the unrolled
//    code.  Only the pivot rows pass through shared memory: the warp that
//    owns the next pair multiplies its two rows, already shifted by E_K, by
//    P^-1 and writes them into the other half of a double buffer right
//    after its update, so the others load W ready to use, and a pair costs
//    ONE barrier among the matrix's own warps (a named barrier: the two
//    sweeps of a block drift apart and fill each other's stalls).  An odd
//    n ends on a single pivot, published with P^-1 = diag(1 / A[k,k], 0).
//    (One pivot a barrier, the same tile otherwise, was 25% slower on an
//    H100: PERF.md.)  The scales come from global memory into shared
//    memory behind the block's only block-wide barrier (an absent second
//    matrix leaves after it), the tile is loaded straight from global
//    memory, neighbouring lanes on
//    neighbouring columns, and scaled on the way in.  For the output every
//    thread writes -a s_r s_s of its tile into an n x (n | 1) buffer in
//    shared memory (an odd row stride: the transposed read has no bank
//    conflicts) and, after one barrier, stores 0.5 (S[r,s] + S[s,r])
//    coalesced; the two terms are the same two floats in either order, so
//    the output is bitwise symmetric.  512 threads, at most 64 registers
//    (two blocks per SM); the smallest tile, 8 x 2, covers n = 64, the
//    largest, 12 x 3, n = 96.  The next, 16 x 4, would keep 64 entries and
//    20 pivot operands in a thread, more than the 64 registers of two such
//    blocks per SM.
//  * The shared-memory route, 96 < n <= 238 (sweep_kernel): one block of
//    256 threads a matrix in shared memory, walked by a 32-wide 2-D layout;
//    the threads that update row k+1 and column k+1 also write them into
//    the next pivot's snapshot buffers, so a pivot costs one barrier and
//    one reciprocal per thread.  232 KB of shared memory hold n = 238.
// All arithmetic is fp32; the kernel allocates nothing and runs on the
// caller's stream.

#include <cuda_runtime.h>

#include "warp_sweep.cuh"

constexpr int kWarps = 8;                        // warps that sweep a matrix
constexpr int kMats = 2;                         // matrices a block
constexpr int kTileThreads = kWarps * kMats * 32;
static_assert(32 % kWarps == 0, "a group of pivots must share its column");

// ---------------------------------------------------------------------------
// register route
// ---------------------------------------------------------------------------

// Row of tile slot i of warp w: the pair (2 m, 2 m + 1), m = w + 8 (i / 2),
// lies in one warp.
__device__ __forceinline__ int tile_row(int w, int i) {
  return 2 * (w + kWarps * (i >> 1)) + (i & 1);
}

__device__ __forceinline__ void matrix_barrier(int mi) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + mi), "n"(kWarps * 32)
               : "memory");
}

// Pair (kn, kn + 1)'s snapshot, on the warp that owns both rows in tile
// rows in, in + 1: the two rows of P^-1 (A[K,:] - E_K^T), interleaved
// (2 x 32 * TC floats, one 8-byte load a column).  Where kn + 1 = n (odd
// n) the step is a single pivot: P^-1 = diag(1 / A[kn,kn], 0), and the
// second row is zero.
template <int TR, int TC>
__device__ __forceinline__ void publish_two(const float (&t)[TR][TC], int in,
                                            int jk, int kn, int n, int lane,
                                            float2* dst) {
#pragma unroll
  for (int i = 0; i + 1 < TR; i += 2) {
    if (i != in) continue;
    float p00 = 0.0f, p01 = 0.0f, p10 = 0.0f, p11 = 0.0f;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      if (j != jk) continue;
      p00 = __shfl_sync(0xffffffffu, t[i][j], kn & 31);
      p01 = __shfl_sync(0xffffffffu, t[i][j], (kn & 31) + 1);
      p10 = __shfl_sync(0xffffffffu, t[i + 1][j], kn & 31);
      p11 = __shfl_sync(0xffffffffu, t[i + 1][j], (kn & 31) + 1);
    }
    float q00, q01, q10, q11;
    if (kn + 1 < n) {
      const float det = fmaf(p00, p11, -p01 * p10);
      const float id = 1.0f / det;
      q00 = p11 * id;
      q01 = -p01 * id;
      q10 = -p10 * id;
      q11 = p00 * id;
    } else {
      q00 = 1.0f / p00;
      q01 = q10 = q11 = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int s = lane + 32 * j;
      const float x0 = s == kn ? t[i][j] - 1.0f : t[i][j];
      const float x1 = s == kn + 1 ? t[i + 1][j] - 1.0f : t[i + 1][j];
      dst[s] = make_float2(fmaf(q00, x0, q01 * x1), fmaf(q10, x0, q11 * x1));
    }
  }
}

// skip (profiling only, the outputs are then wrong): bit 0 leaves out the
// pivot loop, bit 1 the scaling, unscaling and symmetrisation.
template <int TR, int TC>
__global__ void __launch_bounds__(kTileThreads, 2)
sweep_tile_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int batch, int n, int skip) {
  static_assert(TR % 2 == 0, "a pair of pivot rows lies in one warp");
  extern __shared__ float sm[];
  constexpr int CP = 32 * TC;
  constexpr int SNAP = 2 * CP;                  // one step's two pivot rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = warp / kWarps, wr = warp - mi * kWarps;
  const size_t g = (size_t)blockIdx.x * kMats + mi;
  const bool live = g < (size_t)batch;
  // the snapshots come first: their offsets do not depend on n
  float* snap = sm + mi * 2 * SNAP;
  float* scl = sm + kMats * 2 * SNAP + mi * n;
  const float* src = a + g * n * n;

  if (live)
    for (int i = tid - mi * kWarps * 32; i < n; i += kWarps * 32)
      scl[i] = (skip & 2) ? 1.0f : rsqrtf(src[(size_t)i * n + i]);
  __syncthreads();   // the only block-wide barrier
  if (!live) return;

  // ---- my entries, scaled, into my register tile ----
  float t[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = tile_row(wr, i);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int s = lane + 32 * j;
      t[i][j] = (r < n && s < n) ? src[(size_t)r * n + s] * (scl[r] * scl[s])
                                 : 0.0f;
    }
  }

  // Every count below is taken from the kernel's arguments where it is
  // needed, so that nothing but the tile, the pivot rows and the indices
  // stays live across the pivot loop (two blocks of 512 threads leave 64
  // registers a thread).
  // Pairs 8 m + u are in tile rows 2 m, 2 m + 1 of warp u.
  float2* snap2 = reinterpret_cast<float2*>(snap);
  if (wr == 0) publish_two<TR, TC>(t, 0, 0, 0, n, lane, snap2);
  matrix_barrier(mi);
  if (!(skip & 1)) {
#pragma unroll
    for (int m = 0; m < TR / 2; ++m) {
      const int jk = 2 * m * kWarps / 32;      // the group's tile column
#pragma unroll 1
      for (int p = kWarps * m; p < kWarps * (m + 1) && 2 * p < n; ++p) {
        const int l0 = (2 * p) & 31;
        const float2* cur = snap2 + (p & 1) * CP;
        float2 w[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) w[j] = cur[lane + 32 * j];
        const bool mine = p - kWarps * m == wr;
#pragma unroll
        for (int ii = 0; ii < TR; ++ii) {
          float v0 = __shfl_sync(0xffffffffu, t[ii][jk], l0);
          float v1 = __shfl_sync(0xffffffffu, t[ii][jk], l0 + 1);
          if (ii == 2 * m && mine) v0 -= 1.0f;
          if (ii == 2 * m + 1 && mine) v1 -= 1.0f;
#pragma unroll
          for (int j = 0; j < TC; ++j)
            t[ii][j] = fmaf(-v1, w[j].y, fmaf(-v0, w[j].x, t[ii][j]));
        }
        // the rank-2 form over-counts each pivot entry by 2
        if (mine) {
          if (lane == l0) t[2 * m][jk] -= 2.0f;
          if (lane == l0 + 1) t[2 * m + 1][jk] -= 2.0f;
        }
        const int pn = p + 1;
        float2* nxt = snap2 + (pn & 1) * CP;
        if (2 * pn < n) {
          if (pn < kWarps * (m + 1)) {
            if (wr == pn - kWarps * m)
              publish_two<TR, TC>(t, 2 * m, jk, 2 * pn, n, lane, nxt);
          } else if (wr == 0) {
            publish_two<TR, TC>(t, 2 * m + 2, (2 * m + 2) * kWarps / 32,
                                2 * pn, n, lane, nxt);
          }
        }
        matrix_barrier(mi);
      }
    }
  }

  // ---- sign, unscale, symmetrise ----
  // (the indices pass through an empty asm, and the addresses are formed
  // anew, so that nothing computed for the tile load is kept alive, and
  // spilled, across the sweep for reuse here)
  int mi2 = mi, wr2 = wr, lane2 = lane;
  asm volatile("" : "+r"(mi2), "+r"(wr2), "+r"(lane2));
  float* dst = out + ((size_t)blockIdx.x * kMats + mi2) * n * n;
  if (skip & 2) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = tile_row(wr2, i);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int s = lane2 + 32 * j;
        if (r < n && s < n) dst[r * n + s] = t[i][j];
      }
    }
    return;
  }
  const int ld = n | 1;
  const float* scl2 = sm + kMats * 2 * SNAP + mi2 * n;
  float* S = sm + kMats * (2 * SNAP + n) + mi2 * n * ld;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = tile_row(wr2, i);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int s = lane2 + 32 * j;
      if (r < n && s < n) S[r * ld + s] = -t[i][j] * scl2[r] * scl2[s];
    }
  }
  matrix_barrier(mi2);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = tile_row(wr2, i);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int s = lane2 + 32 * j;
      if (r < n && s < n)
        dst[r * n + s] = 0.5f * (S[r * ld + s] + S[s * ld + r]);
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory route
// ---------------------------------------------------------------------------

// skip: as for the register route.
__global__ void sweep_kernel(const float* __restrict__ a,
                             float* __restrict__ out, int n, int skip) {
  extern __shared__ float smem[];
  float* A = smem;              // (n, n), Jacobi-scaled, swept in place
  float* scl = A + n * n;       // (n) rsqrt of the diagonal
  float* snap = scl + n;        // 2 buffers x (column (n), row (n))

  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid & 31, ty = tid >> 5, nwarp = nt >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;

  for (int i = tid; i < n * n; i += nt) A[i] = a[base + i];
  __syncthreads();
  const bool raw = skip & 2;
  if (!raw) {
    for (int i = tid; i < n; i += nt) scl[i] = rsqrtf(A[i * n + i]);
    __syncthreads();
    for (int r = ty; r < n; r += nwarp)
      for (int s = tx; s < n; s += 32) A[r * n + s] *= scl[r] * scl[s];
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt) {   // snapshot of pivot 0
    snap[i] = A[i * n];
    snap[n + i] = A[i];
  }
  __syncthreads();

  const int npiv = (skip & 1) ? 0 : n;
  for (int k = 0; k < npiv; ++k) {
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
          raw ? A[r * n + s]
              : -0.5f * (A[r * n + s] + A[s * n + r]) * (scl[r] * scl[s]);
}

// ---------------------------------------------------------------------------
// one-warp route, n <= 32
// ---------------------------------------------------------------------------

// Matrices (warps) a block: 1, 2, 4 and 8 took the same time on an H100
// (PERF.md); ops/sweep.py WARP_MATS mirrors it.
constexpr int kWarpMats = 4;

// One warp sweeps one matrix: lane s holds column s (T rows, zeros beyond
// n) in registers.  For pivot k the column entries (r, k) come by
// shuffles from lane k and the pivot-row entry (k, s) is the lane's own
// register k, both taken before the update (warp_sweep.cuh, shared with
// kernel A); no barrier, and the matrix never passes through shared
// memory.  The kWarpMats warps of a block are independent.  The
// symmetrisation goes through a
// T x (T + 1) buffer of the warp's own (an odd row stride: the transposed
// read has no bank conflicts), behind a __syncwarp.  skip: as for the
// register route.
template <int T>
__global__ void __launch_bounds__(kWarpMats * 32)
sweep_warp_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int batch, int n, int skip) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t g = (size_t)blockIdx.x * kWarpMats + w;
  if (g >= (size_t)batch) return;   // the whole warp
  const float* src = a + g * n * n;
  const bool col = lane < n;
  const float sc = !col ? 0.0f
                   : (skip & 2) ? 1.0f
                                : rsqrtf(src[(size_t)lane * n + lane]);

  // ---- column `lane`, scaled, into registers ----
  float x[T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const float sr = __shfl_sync(0xffffffffu, sc, r);
    x[r] = (r < n && col) ? src[(size_t)r * n + lane] * sr * sc : 0.0f;
  }

  // ---- the sweep, as kernel A's one-warp route runs it ----
  warp_sweep<T>(x, (skip & 1) ? 0 : n, lane);

  // ---- sign, unscale, symmetrise; neighbouring lanes store neighbouring
  // columns ----
  float* dst = out + g * n * n;
  if (skip & 2) {
#pragma unroll
    for (int r = 0; r < T; ++r)
      if (r < n && col) dst[r * n + lane] = x[r];
    return;
  }
  constexpr int LD = T + 1;
  float* S = sm + w * T * LD;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const float sr = __shfl_sync(0xffffffffu, sc, r);
    if (r < n && col) S[r * LD + lane] = -x[r] * sr * sc;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < T; ++r)
    if (r < n && col)
      dst[r * n + lane] = 0.5f * (S[r * LD + lane] + S[lane * LD + r]);
}

// ---------------------------------------------------------------------------
// C interface: tc = 1 selects the one-warp route (T = tr, kWarpMats
// matrices a block), tr = 0 the shared-memory route, any other (tr, tc) a register
// tile
// ---------------------------------------------------------------------------

constexpr int kSmemThreads = 256;

typedef void (*SweepKernel)(const float*, float*, int, int, int);

// The instantiated routes: WARP_TILE(T) covers n <= T; TILE(TR, TC) covers
// n <= min(8 TR, 32 TC), TR even.  ops/sweep.py lists the same shapes
// (TILE_SHAPES) and chooses.
static SweepKernel pick(int tr, int tc) {
#define WARP_TILE(T) \
  if (tr == T && tc == 1) return sweep_warp_kernel<T>;
#define TILE(TR, TC) \
  if (tr == TR && tc == TC) return sweep_tile_kernel<TR, TC>;
  WARP_TILE(16)
  WARP_TILE(32)
  TILE(8, 2)
  TILE(10, 3)
  TILE(12, 3)
#undef TILE
#undef WARP_TILE
  return nullptr;
}

static bool warp_route(int tr, int tc) { return tr > 0 && tc == 1; }

extern "C" size_t sweep_smem_bytes(int n, int tr, int tc) {
  if (tr == 0) return ((size_t)n * n + 5 * (size_t)n) * sizeof(float);
  if (warp_route(tr, tc))
    return (size_t)kWarpMats * tr * (tr + 1) * sizeof(float);
  const size_t snap = (size_t)2 * 32 * tc;
  return (size_t)kMats * (2 * snap + n + (size_t)n * (n | 1)) * sizeof(float);
}

// The kernel of a route, its threads a block and its dynamic shared
// memory, with the limit raised where it passes 48 KB; nullptr where n
// does not fit the route.
static const void* prepare(int n, int tr, int tc, int* threads,
                           size_t* smem, cudaError_t* err) {
  *err = cudaSuccess;
  const void* fn;
  if (tr == 0) {
    fn = (const void*)sweep_kernel;
    *threads = kSmemThreads;
  } else if (warp_route(tr, tc)) {
    fn = (const void*)pick(tr, tc);
    if (!fn || n > tr) return nullptr;
    *threads = 32 * kWarpMats;
  } else {
    fn = (const void*)pick(tr, tc);
    if (!fn || n > kWarps * tr || n > 32 * tc) return nullptr;
    *threads = kTileThreads;
  }
  if (n < 1) return nullptr;
  *smem = sweep_smem_bytes(n, tr, tc);
  if (*smem > 48 * 1024)
    *err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return fn;
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int sweep_resources(int n, int tr, int tc, int* out4) {
  size_t smem = 0;
  int threads = 0;
  cudaError_t err;
  const void* fn = prepare(n, tr, tc, &threads, &smem, &err);
  if (!fn) return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)(smem + a.sharedSizeBytes);
  out4[3] = blocks;
  return (int)err;
}

// skip: the kernels' profiling bits 0 and 1.
extern "C" int sweep_launch(const float* a, float* out, int batch, int n,
                            int tr, int tc, void* stream, int skip) {
  size_t smem = 0;
  int threads = 0;
  cudaError_t err;
  const void* fn = prepare(n, tr, tc, &threads, &smem, &err);
  if (!fn) return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (tr == 0) {
    sweep_kernel<<<batch, threads, smem, st>>>(a, out, n, skip & 3);
  } else {
    const int per = warp_route(tr, tc) ? kWarpMats : kMats;   // a block
    ((SweepKernel)fn)<<<(batch + per - 1) / per, threads, smem, st>>>(
        a, out, batch, n, skip & 3);
  }
  return (int)cudaGetLastError();
}
