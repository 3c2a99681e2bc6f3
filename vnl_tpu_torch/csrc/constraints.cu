// Kernel D: the constraint system of one physics substep, joint limits and
// pyramidal contacts, in the form kernel B takes it; one thread block per
// env.
//
// Replaces, where kernel B solves, the plain PyTorch assembly of
// physics/constraint.py make_constraints and the packing of
// physics/solver.py cg_inputs: at the rodent twin's shapes about 187
// elementwise, gather and einsum launches a substep, each over a tensor of
// a few thousand floats.  Its outputs are kernel B's inputs:
//   g36 (B, 36, ncon): per contact the rows [r2 x frame | frame] of side 2,
//     then those of side 1, f-major (row sd * 18 + f * 6 + j);
//   lim_sign, lim_aref, lim_D, lim_pos (B, nlimit): one row a limited joint,
//     or for a model without limits the inert row (sign 0, D 0) kernel B
//     needs;
//   con_aref, con_D (B, ncon, 4): one entry a pyramid facet n +- mu t;
//   con_pos (B, ncon): the contact's distance less its margin.
//
// What bounds it on an H100: per env it reads qpos, qvel, cdof, the subtree
// coms of the contacts' roots and the contacts' distances, points and
// frames (about 4 KB at the twin's shapes) and writes about 5 KB: under a
// microsecond at 128 envs against 3.35 TB/s.  The arithmetic is a few
// hundred operations a row.  So a launch costs its latency: three short
// phases with two barriers between them.
//
// Design:
//  * Everything static comes as tables built once per model by
//    ops/constraints.py, in float32 by the plain version's own PyTorch
//    expressions: per limit row its qpos and dof addresses, range, margin,
//    solimp (with the clamps that do not depend on the state already
//    applied), (k, b) and dof_invweight0; per contact slot its two sides'
//    root bodies and chain groups, margin, margin - gap, solimp, (k, b),
//    friction, the four facets' diagonal and which facets act.  Float
//    tables are field-major, so the threads of a warp read one field of
//    neighbouring rows together.
//  * J qvel in the contact frame is G2 s2 - G1 s1, with s the sum of
//    cdof * qvel over a side's kinematic chain.  A chain is a body's, and
//    the contacts of a scene share few bodies, so s is summed once a group
//    (a body that carries contacts: ops/cg.py body_tables) from cdof * qvel
//    staged in shared memory, in ascending dof order.  The groups' dof
//    lists are staged too: walked from device memory, each step of a
//    chain would wait on the load of its index.
//  * Phase 1: the threads stage cdof * qvel and the dof lists and work out
//    the limit rows, which need nothing else.  Phase 2: one thread a (group, component)
//    sums its chain.  Phase 3: one thread a contact slot builds its 36 G
//    entries, J qvel, impedance, reference accelerations and D.  Every
//    phase loops over its items with the block's stride, so a model with
//    more rows takes the same code with more trips.
//  * Each product, sum, quotient and clamp is rounded on its own, as the
//    plain version's separate PyTorch operations are (__fmul_rn and its
//    kin keep the compiler from contracting them into FMAs), and the
//    clamps pass NaN on as torch.clamp does: every output but con_aref
//    has the plain version's bits.  The sums of J qvel, over a chain
//    (ascending, one rounding a term) and over a G row (fused
//    multiply-adds), are in an order of their own: the plain version's
//    are cuBLAS products, whose order changes with the batch.
// fp32 throughout; the kernel allocates nothing and runs on the caller's
// stream.

#include <cuda_runtime.h>

struct ConModel {
  int nq, nv, nbody, ncon, nlimit, ngrp, ngdof;
  const int* lim_int;     // (2, nlimit): qpos address, dof address
  const float* lim_flt;   // (kLimF, nlimit), fields below
  const int* con_int;     // (4, ncon): root of side 1, root of side 2,
                          // group of side 1, group of side 2 (ngrp: none)
  const float* con_flt;   // (kConF, ncon), fields below
  const int* grp_start;   // (ngrp + 1) offsets into grp_dof
  const int* grp_dof;     // (ngdof) dofs of each group's chain, ascending
};

struct ConIn {
  const float *qpos, *qvel, *subtree_com, *cdof, *con_dist, *con_pos,
      *con_frame;
};

struct ConOut {
  float *g36, *lim_sign, *lim_aref, *lim_D, *lim_pos, *con_aref, *con_D,
      *con_pos;
};

// The fields of the float tables (ops/constraints.py LIMIT_FIELDS and
// CONTACT_FIELDS name them in this order).
enum LimF { kLo, kHi, kLMargin, kLD0, kLDmax, kLWidth, kLMid, kLPower, kLK,
            kLB, kInvW, kLimF };
enum ConF { kMargin, kThresh, kD0, kDmax, kWidth, kMid, kPower, kK, kB,
            kMu1, kMu2, kDiag0, kOn0 = kDiag0 + 4, kConF = kOn0 + 4 };

constexpr int kThreads = 128;   // threads per block (one block per env)

// torch's float32 constants of the plain version (a Python float rounded
// once to float32)
constexpr float kImpLo = (float)1e-5;
constexpr float kImpHi = (float)(1.0 - 1e-5);
constexpr float kImpOff = (float)1e-7;
constexpr float kRMin = (float)1e-10;

// torch.clamp / torch.minimum: NaN in, NaN out
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float minf(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// MuJoCo's solimp sigmoid (constraint.py _impedance) at violation r; the
// width, mid and power arrive clamped
__device__ float impedance(float d0, float dmax, float width, float mid,
                           float power, float r) {
  const float x = clampf(__fdiv_rn(fabsf(r), width), 0.f, 1.f);
  const float y_lo = __fmul_rn(powf(__fdiv_rn(x, mid), power), mid);
  const float one_mid = __fsub_rn(1.f, mid);
  const float y_hi = __fsub_rn(
      1.f, __fmul_rn(powf(__fdiv_rn(__fsub_rn(1.f, x), one_mid), power),
                     one_mid));
  const float y = x < mid ? y_lo : y_hi;
  return clampf(__fadd_rn(d0, __fmul_rn(y, __fsub_rn(dmax, d0))), kImpLo,
                kImpHi);
}

__global__ void __launch_bounds__(kThreads)
constraints_kernel(ConModel m, ConIn in, ConOut out) {
  extern __shared__ float smem[];
  float* cx = smem;               // (nv, 6) cdof * qvel
  float* s = smem + 6 * m.nv;     // (ngrp + 1, 6) chain sums; the last: none
  int* gdof = (int*)(s + 6 * (m.ngrp + 1));   // (ngdof) m.grp_dof
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nv = m.nv, nc = m.ncon, nl = m.nlimit;
  const float* qvel = in.qvel + (size_t)b * nv;

  // phase 1: cdof * qvel, the dof lists, the limit rows
  const float* cdof = in.cdof + (size_t)b * nv * 6;
  for (int i = tid; i < 6 * nv; i += kThreads)
    cx[i] = __fmul_rn(cdof[i], qvel[i / 6]);
  for (int i = tid; i < m.ngdof; i += kThreads) gdof[i] = m.grp_dof[i];
  if (tid < 6) s[6 * m.ngrp + tid] = 0.f;
  const int nl_out = nl > 0 ? nl : 1;
  for (int l = tid; l < nl; l += kThreads) {
    const float* t = m.lim_flt + l;
    const float q = in.qpos[(size_t)b * m.nq + m.lim_int[l]];
    const float dlo = __fsub_rn(q, t[kLo * nl]);
    const float dhi = __fsub_rn(t[kHi * nl], q);
    const float sign = dlo < dhi ? 1.f : -1.f;
    const float pos = __fsub_rn(minf(dlo, dhi), t[kLMargin * nl]);
    const float imp = pos < 0.f
        ? impedance(t[kLD0 * nl], t[kLDmax * nl], t[kLWidth * nl],
                    t[kLMid * nl], t[kLPower * nl], pos)
        : kImpOff;
    const float vel = __fmul_rn(sign, qvel[m.lim_int[nl + l]]);
    const float R = clampf(
        __fmul_rn(__fdiv_rn(__fsub_rn(1.f, imp), imp), t[kInvW * nl]), kRMin,
        INFINITY);
    const size_t o = (size_t)b * nl_out + l;
    out.lim_sign[o] = sign;
    out.lim_aref[o] = __fsub_rn(__fmul_rn(-t[kLB * nl], vel),
                                __fmul_rn(__fmul_rn(t[kLK * nl], imp), pos));
    out.lim_D[o] = __fdiv_rn(1.f, R);
    out.lim_pos[o] = pos;
  }
  if (nl == 0 && tid == 0) {
    out.lim_sign[b] = 0.f;
    out.lim_aref[b] = 0.f;
    out.lim_D[b] = 0.f;
    out.lim_pos[b] = 0.f;
  }
  __syncthreads();

  // phase 2: each group's chain sum of cdof * qvel
  for (int i = tid; i < 6 * m.ngrp; i += kThreads) {
    const int g = i / 6, k = i - 6 * g;
    float acc = 0.f;
    const int end = m.grp_start[g + 1];
    for (int j = m.grp_start[g]; j < end; ++j)
      acc = __fadd_rn(acc, cx[6 * gdof[j] + k]);
    s[i] = acc;
  }
  __syncthreads();

  // phase 3: the contact slots
  for (int c = tid; c < nc; c += kThreads) {
    const float* t = m.con_flt + c;
    const size_t bc = (size_t)b * nc + c;
    const float* p = in.con_pos + 3 * bc;
    const float* F = in.con_frame + 9 * bc;
    float frame[9];
    for (int i = 0; i < 9; ++i) frame[i] = F[i];
    const float px = p[0], py = p[1], pz = p[2];
    float* g = out.g36 + (size_t)b * 36 * nc + c;
    float vel[3] = {0.f, 0.f, 0.f};
    for (int sd = 0; sd < 2; ++sd) {      // side 2 (added), then side 1
      const int root = m.con_int[(1 - sd) * nc + c];
      const float* sc = s + 6 * m.con_int[(3 - sd) * nc + c];
      const float* com = in.subtree_com + ((size_t)b * m.nbody + root) * 3;
      const float rx = __fsub_rn(px, com[0]), ry = __fsub_rn(py, com[1]),
                  rz = __fsub_rn(pz, com[2]);
      for (int f = 0; f < 3; ++f) {
        const float fx = frame[3 * f], fy = frame[3 * f + 1],
                    fz = frame[3 * f + 2];
        float G[6];
        G[0] = __fsub_rn(__fmul_rn(ry, fz), __fmul_rn(rz, fy));
        G[1] = __fsub_rn(__fmul_rn(rz, fx), __fmul_rn(rx, fz));
        G[2] = __fsub_rn(__fmul_rn(rx, fy), __fmul_rn(ry, fx));
        G[3] = fx;
        G[4] = fy;
        G[5] = fz;
        float acc = 0.f;
        for (int j = 0; j < 6; ++j) {
          g[(size_t)(18 * sd + 6 * f + j) * nc] = G[j];
          acc = fmaf(G[j], sc[j], acc);
        }
        vel[f] = sd == 0 ? acc : __fsub_rn(vel[f], acc);
      }
    }
    const float dist = in.con_dist[bc];
    const float pos = __fsub_rn(dist, t[kMargin * nc]);
    const float imp = dist < t[kThresh * nc]
        ? impedance(t[kD0 * nc], t[kDmax * nc], t[kWidth * nc],
                    t[kMid * nc], t[kPower * nc], pos)
        : kImpOff;
    const float mu1 = t[kMu1 * nc], mu2 = t[kMu2 * nc];
    const float mt1 = __fmul_rn(mu1, vel[1]), mt2 = __fmul_rn(mu2, vel[2]);
    const float fvel[4] = {__fadd_rn(vel[0], mt1), __fsub_rn(vel[0], mt1),
                           __fadd_rn(vel[0], mt2), __fsub_rn(vel[0], mt2)};
    const float ratio = __fdiv_rn(__fsub_rn(1.f, imp), imp);
    const float kip = __fmul_rn(__fmul_rn(t[kK * nc], imp), pos);
    const float nb = -t[kB * nc];
    for (int f = 0; f < 4; ++f) {
      const float on = t[(kOn0 + f) * nc];
      const float R = clampf(__fmul_rn(ratio, t[(kDiag0 + f) * nc]), kRMin,
                             INFINITY);
      out.con_aref[4 * bc + f] =
          __fmul_rn(__fsub_rn(__fmul_rn(nb, fvel[f]), kip), on);
      out.con_D[4 * bc + f] = __fdiv_rn(on, R);
    }
    out.con_pos[bc] = pos;
  }
}

static size_t smem_bytes(const ConModel& m) {
  return (size_t)(6 * m.nv + 6 * (m.ngrp + 1)) * sizeof(float) +
         (size_t)m.ngdof * sizeof(int);
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int constraints_resources(ConModel m, int* out4) {
  const void* fn = (const void*)constraints_kernel;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem_bytes(m));
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)(smem_bytes(m) + a.sharedSizeBytes);
  out4[3] = blocks;
  return (int)err;
}

extern "C" int constraints_launch(ConModel m, ConIn in, ConOut out,
                                  int batch, void* stream) {
  // what is staged must fit the default 48 KB
  if (m.ncon < 1 || smem_bytes(m) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  constraints_kernel<<<batch, kThreads, smem_bytes(m),
                       (cudaStream_t)stream>>>(m, in, out);
  return (int)cudaGetLastError();
}
