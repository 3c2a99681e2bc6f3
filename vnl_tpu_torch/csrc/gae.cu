// Kernel F: GAE's TD(lambda) value targets and advantages over a [T, B]
// unroll in one launch; one thread per column b (a row of the minibatch).
//
// Replaces no TPU kernel: the JAX package's compute_gae
// (vnl_tpu/training/losses.py) is a lax.scan that XLA compiles.  On the
// card the plain version (ops/gae.py compute_gae_plain) is a Python loop
// over the unroll, 7 elementwise launches a step on B-element vectors,
// with its set-up and its stacks 151 of the 434 nodes of an SGD update's
// CUDA graph at the training cells' [20, 32].  Its outputs:
//   targets, advantages (T, B), float32, contiguous.
//
// What bounds it on an H100: it reads 4 T B + B floats and writes 2 T B,
// 15.5 KB at [20, 32] (under 5 ns against 3.35 TB/s) and 0.5 MB at
// [20, 1024]; the arithmetic is 14 operations an element.  The real cost
// is the launch's latency and the chain of T dependent steps a column
// takes, a few fp32 operations each.  So the design keeps the launch one
// short pass: no shared memory, no barrier, each column's chain in its own
// thread's registers.
//
// Design:
//  * Thread b walks its column from t = T - 1 down to 0, carrying gae and
//    the next step's value.  It first issues the loads of up to kChunk
//    steps (truncation, termination, reward and value of each) into
//    registers, then runs their chain: one round trip to memory a chunk,
//    one for the cells' T = 20.
//  * The inputs come as they lie, each with its element strides: the loss
//    hands over time-major views of [B, T] buffers, which a copy to a
//    contiguous layout would cost a launch each.  The outputs are written
//    [T, B], so a warp's stores of one step are coalesced.
//  * The plain loop's operations in its order, each rounded on its own
//    (the source is built with -fmad=false, ops/__init__.py KERNELS), as
//    its separate PyTorch operations round them:
//      mask = 1 - truncation,  cont = discount * (1 - termination),
//      delta = (reward + cont * next_value) - value,
//      advantage = mask * (delta + cont * gae),
//      gae = mask * (delta + (lambda * cont) * gae),  target = gae + value;
//    so the outputs have the plain version's bits.
// fp32 throughout; the kernel allocates nothing and runs on the caller's
// stream.

#include <cuda_runtime.h>

constexpr int kThreads = 128;
constexpr int kChunk = 32;   // steps whose loads a thread issues at once

// a [T, B] input: element (t, b) at p[t * st + b * sb]
struct Seq {
  const float* p;
  long long st, sb;
};

struct GaeIn {
  Seq truncation, termination, rewards, values;
  const float* bootstrap;     // (B,): element b at bootstrap[b * bootstrap_sb]
  long long bootstrap_sb;
};

struct GaeOut {
  float *targets, *advantages;   // (T, B), contiguous
};

__device__ __forceinline__ float at(const Seq& s, long long t, long long b) {
  return s.p[t * s.st + b * s.sb];
}

__global__ void __launch_bounds__(kThreads)
gae_kernel(GaeIn in, GaeOut out, int T, int B, float lambda,
           float discount) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float gae = 0.f;
  float next_value = in.bootstrap[(long long)b * in.bootstrap_sb];
  for (int hi = T; hi > 0; hi -= kChunk) {
    // steps hi - 1 down to hi - kChunk (those >= 0), loads first
    float trunc[kChunk], term[kChunk], reward[kChunk], value[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = hi - 1 - k;
      if (t >= 0) {
        trunc[k] = at(in.truncation, t, b);
        term[k] = at(in.termination, t, b);
        reward[k] = at(in.rewards, t, b);
        value[k] = at(in.values, t, b);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = hi - 1 - k;
      if (t >= 0) {
        const float mask = 1.f - trunc[k];
        const float cont = discount * (1.f - term[k]);
        const float delta = (reward[k] + cont * next_value) - value[k];
        const long long i = (long long)t * B + b;
        out.advantages[i] = mask * (delta + cont * gae);
        gae = mask * (delta + (lambda * cont) * gae);
        out.targets[i] = gae + value[k];
        next_value = value[k];
      }
    }
  }
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int gae_resources(int* out4) {
  const void* fn = (const void*)gae_kernel;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)a.sharedSizeBytes;
  out4[3] = blocks;
  return (int)err;
}

extern "C" int gae_launch(GaeIn in, GaeOut out, int T, int B, float lambda,
                          float discount, void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, T, B, lambda, discount);
  return (int)cudaGetLastError();
}
