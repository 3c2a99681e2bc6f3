// Kernel A: the whole position stage of one physics substep, one thread
// block per env.
//
// Replaces the TPU kernel vnl_tpu/ops/pallas_position.py::_position_kernel
// (built by make_position_fused): qpos -> joint transforms, world poses,
// geom poses, subtree com, cinert, cdof, the CRB mass matrix qM (+armature)
// and, by a Jacobi-scaled symmetric sweep, qM^-1 and (qM + h diag(B))^-1.
//
// What bounds it on an H100: per env it reads 74 floats and writes about
// 75 KB (three 73x73 matrices dominate), and the two sweeps are
// 2 * 2 * nv^3 ~ 1.6 MFLOP of fp32 FMA work outside the tensor cores.  At
// B = 1024 both limits are tens of microseconds; the sweeps' 73 pivot
// steps, each a block-wide barrier, are the real cost of this first
// version.
//
// Design: the TPU layout (batch in 128 lanes, tree gathers as one-hot
// matmuls) is not carried over.  Each block owns one env and keeps every
// per-env quantity in shared memory: bodies are composed level by level
// (threads over the bodies of one tree level), subtree sums run in reverse
// body order, qM is assembled by walking each dof's parent-dof chain, and
// both inverses are swept pivot by pivot with threads over the matrix
// entries of both matrices at once.  All arithmetic is fp32; the kernel
// allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>

struct PosModel {
  int nb, nj, nv, nq, ng, damped, nlevel;
  const int* body_parent;   // (nb)
  const int* body_jntadr;   // (nb)
  const int* body_jntnum;   // (nb)
  const int* body_rootid;   // (nb)
  const int* level_start;   // (nlevel + 1) offsets into level_body
  const int* level_body;    // bodies 1..nb-1 ordered by tree depth
  const int* jnt_type;      // (nj) 0 free, 1 ball, 2 slide, 3 hinge
  const int* jnt_qposadr;   // (nj)
  const int* jnt_bodyid;    // (nj)
  const int* geom_bodyid;   // (ng)
  const int* dof_bodyid;    // (nv)
  const int* dof_jntid;     // (nv)
  const int* dof_parent;    // (nv) parent dof, -1 at a root
  const int* dof_kind;      // (nv) 0 free translation, 1 local rotation,
                            //      2 hinge, 3 slide
  const int* dof_axis;      // (nv) axis index for kinds 0 and 1
  const float* qpos0;       // (nq)
  const float* body_pos;    // (nb, 3)
  const float* body_quat;   // (nb, 4)
  const float* body_ipos;   // (nb, 3)
  const float* body_iquat;  // (nb, 4)
  const float* body_mass;   // (nb)
  const float* body_inertia;  // (nb, 3)
  const float* subtree_mass;  // (nb) max(sum of subtree masses, 1e-12)
  const float* jnt_pos;     // (nj, 3)
  const float* jnt_axis;    // (nj, 3)
  const float* geom_pos;    // (ng, 3)
  const float* geom_quat;   // (ng, 4)
  const float* armature;    // (nv)
  const float* hB;          // (nv) timestep * damping
};

struct PosOut {
  float *xpos, *xquat, *xmat, *xipos, *xanchor, *xaxis, *geom_xpos,
      *geom_xmat, *subtree_com, *cinert, *cdof, *qM, *qMinv, *qMhBinv;
};

__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + 2 w (u x v) + 2 u x (u x v)
__device__ __forceinline__ void qrot(const float* q, const float* v,
                                     float* o) {
  float tx = q[2] * v[2] - q[3] * v[1];
  float ty = q[3] * v[0] - q[1] * v[2];
  float tz = q[1] * v[1] - q[2] * v[0];
  float sx = q[2] * tz - q[3] * ty;
  float sy = q[3] * tx - q[1] * tz;
  float sz = q[1] * ty - q[2] * tx;
  o[0] = v[0] + 2.0f * (q[0] * tx + sx);
  o[1] = v[1] + 2.0f * (q[0] * ty + sy);
  o[2] = v[2] + 2.0f * (q[0] * tz + sz);
}

__device__ __forceinline__ void qnormalize(float* q) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float r = 1.0f / fmaxf(n, 1e-12f);
  q[0] *= r; q[1] *= r; q[2] *= r; q[3] *= r;
}

__device__ __forceinline__ void q2mat(const float* q, float* m) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1.0f - 2.0f * (y * y + z * z); m[1] = 2.0f * (x * y - w * z);
  m[2] = 2.0f * (x * z + w * y);
  m[3] = 2.0f * (x * y + w * z); m[4] = 1.0f - 2.0f * (x * x + z * z);
  m[5] = 2.0f * (y * z - w * x);
  m[6] = 2.0f * (x * z - w * y); m[7] = 2.0f * (y * z + w * x);
  m[8] = 1.0f - 2.0f * (x * x + y * y);
}

__global__ void position_kernel(PosModel m, const float* __restrict__ qpos_g,
                                PosOut out) {
  extern __shared__ float sm[];
  const int nb = m.nb, nj = m.nj, nv = m.nv, nq = m.nq, ng = m.ng;
  const int e = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  float* qpos = sm;                 // nq
  float* xpos = qpos + nq;          // nb*3
  float* xquat = xpos + nb * 3;     // nb*4
  float* xmat = xquat + nb * 4;     // nb*9
  float* xipos = xmat + nb * 9;     // nb*3
  float* scom = xipos + nb * 3;     // nb*3
  float* crb = scom + nb * 3;       // nb*36
  float* anchor = crb + nb * 36;    // nj*3
  float* axis = anchor + nj * 3;    // nj*3
  float* cdof = axis + nj * 3;      // nv*6
  float* A1 = cdof + nv * 6;        // nv*nv
  float* A2 = A1 + nv * nv;         // nv*nv
  float* col = A2 + nv * nv;        // 2*nv  pivot columns
  float* row = col + 2 * nv;        // 2*nv  pivot rows
  float* scl = row + 2 * nv;        // 2*nv  Jacobi scales

  for (int i = tid; i < nq; i += nt) qpos[i] = qpos_g[(size_t)e * nq + i];
  if (tid == 0) {
    xpos[0] = xpos[1] = xpos[2] = 0.0f;
    xquat[0] = 1.0f; xquat[1] = xquat[2] = xquat[3] = 0.0f;
  }
  __syncthreads();

  // ---- world poses, one tree level at a time ----
  for (int lv = 0; lv < m.nlevel; ++lv) {
    const int lo = m.level_start[lv], hi = m.level_start[lv + 1];
    for (int k = lo + tid; k < hi; k += nt) {
      const int b = m.level_body[k];
      const int p = m.body_parent[b];
      float pos[3], quat[4], t[3], q[4];
      qrot(&xquat[p * 4], &m.body_pos[b * 3], t);
      for (int c = 0; c < 3; ++c) pos[c] = xpos[p * 3 + c] + t[c];
      qmul(&xquat[p * 4], &m.body_quat[b * 4], quat);
      const int j0 = m.body_jntadr[b], j1 = j0 + m.body_jntnum[b];
      for (int j = j0; j < j1; ++j) {
        const int qa = m.jnt_qposadr[j];
        const int type = m.jnt_type[j];
        const float* jp = &m.jnt_pos[j * 3];
        const float* ja = &m.jnt_axis[j * 3];
        if (type == 0) {  // free: resets the chain to world
          for (int c = 0; c < 3; ++c) pos[c] = qpos[qa + c];
          for (int c = 0; c < 4; ++c) quat[c] = qpos[qa + 3 + c];
          qnormalize(quat);
          for (int c = 0; c < 3; ++c) axis[j * 3 + c] = ja[c];
          continue;
        }
        qnormalize(quat);  // frame before the joint
        qrot(quat, jp, t);
        for (int c = 0; c < 3; ++c) anchor[j * 3 + c] = pos[c] + t[c];
        qrot(quat, ja, &axis[j * 3]);
        const float scalar = qpos[qa] - m.qpos0[qa];
        float pl[3];
        if (type == 2) {  // slide
          q[0] = 1.0f; q[1] = q[2] = q[3] = 0.0f;
          for (int c = 0; c < 3; ++c) pl[c] = ja[c] * scalar;
        } else {
          if (type == 3) {  // hinge
            const float s = sinf(0.5f * scalar);
            q[0] = cosf(0.5f * scalar);
            q[1] = ja[0] * s; q[2] = ja[1] * s; q[3] = ja[2] * s;
          } else {  // ball
            for (int c = 0; c < 4; ++c) q[c] = qpos[qa + c];
            qnormalize(q);
          }
          qrot(q, jp, t);
          for (int c = 0; c < 3; ++c) pl[c] = jp[c] - t[c];
        }
        qrot(quat, pl, t);
        for (int c = 0; c < 3; ++c) pos[c] += t[c];
        float nq4[4];
        qmul(quat, q, nq4);
        for (int c = 0; c < 4; ++c) quat[c] = nq4[c];
      }
      qnormalize(quat);
      for (int c = 0; c < 3; ++c) xpos[b * 3 + c] = pos[c];
      for (int c = 0; c < 4; ++c) xquat[b * 4 + c] = quat[c];
      for (int j = j0; j < j1; ++j)
        if (m.jnt_type[j] == 0)
          for (int c = 0; c < 3; ++c) anchor[j * 3 + c] = pos[c];
    }
    __syncthreads();
  }

  // ---- per-body frames, geoms, joints ----
  for (int b = tid; b < nb; b += nt) {
    q2mat(&xquat[b * 4], &xmat[b * 9]);
    float t[3];
    qrot(&xquat[b * 4], &m.body_ipos[b * 3], t);
    for (int c = 0; c < 3; ++c) xipos[b * 3 + c] = xpos[b * 3 + c] + t[c];
  }
  for (int g = tid; g < ng; g += nt) {
    const int b = m.geom_bodyid[g];
    float t[3], q[4], mat[9];
    qrot(&xquat[b * 4], &m.geom_pos[g * 3], t);
    float* gp = &out.geom_xpos[((size_t)e * ng + g) * 3];
    for (int c = 0; c < 3; ++c) gp[c] = xpos[b * 3 + c] + t[c];
    qmul(&xquat[b * 4], &m.geom_quat[g * 4], q);
    q2mat(q, mat);
    float* gm = &out.geom_xmat[((size_t)e * ng + g) * 9];
    for (int c = 0; c < 9; ++c) gm[c] = mat[c];
  }
  for (int i = tid; i < nj * 3; i += nt) {
    out.xanchor[(size_t)e * nj * 3 + i] = anchor[i];
    out.xaxis[(size_t)e * nj * 3 + i] = axis[i];
  }
  __syncthreads();

  // ---- subtree com: reverse-order accumulation, one thread per axis ----
  if (tid < 3) {
    const int c = tid;
    for (int b = 0; b < nb; ++b) scom[b * 3 + c] = m.body_mass[b] * xipos[b * 3 + c];
    for (int b = nb - 1; b > 0; --b) scom[m.body_parent[b] * 3 + c] += scom[b * 3 + c];
    for (int b = 0; b < nb; ++b) scom[b * 3 + c] /= m.subtree_mass[b];
  }
  for (int i = tid; i < nb * 3; i += nt) {
    out.xpos[(size_t)e * nb * 3 + i] = xpos[i];
    out.xipos[(size_t)e * nb * 3 + i] = xipos[i];
  }
  for (int i = tid; i < nb * 4; i += nt) out.xquat[(size_t)e * nb * 4 + i] = xquat[i];
  for (int i = tid; i < nb * 9; i += nt) out.xmat[(size_t)e * nb * 9 + i] = xmat[i];
  __syncthreads();
  for (int i = tid; i < nb * 3; i += nt) out.subtree_com[(size_t)e * nb * 3 + i] = scom[i];

  // ---- cinert about each body's root subtree com; cdof ----
  for (int b = tid; b < nb; b += nt) {
    const float* org = &scom[m.body_rootid[b] * 3];
    float iq[4], R[9];
    qmul(&xquat[b * 4], &m.body_iquat[b * 4], iq);
    q2mat(iq, R);
    const float* I = &m.body_inertia[b * 3];
    const float mass = m.body_mass[b];
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = xipos[b * 3 + k] - org[k];
    const float cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    // skew(c) = [[0,-z,y],[z,0,-x],[-y,x,0]]
    const float cx[9] = {0.0f, -c[2], c[1], c[2], 0.0f, -c[0], -c[1], c[0], 0.0f};
    float* ci = &crb[b * 36];
    for (int r = 0; r < 3; ++r) {
      for (int s = 0; s < 3; ++s) {
        float ic = R[r * 3 + 0] * I[0] * R[s * 3 + 0] + R[r * 3 + 1] * I[1] * R[s * 3 + 1] +
                   R[r * 3 + 2] * I[2] * R[s * 3 + 2];
        ci[r * 6 + s] = ic + mass * ((r == s ? cc : 0.0f) - c[r] * c[s]);
        ci[r * 6 + s + 3] = mass * cx[r * 3 + s];
        ci[(r + 3) * 6 + s] = mass * cx[s * 3 + r];
        ci[(r + 3) * 6 + s + 3] = (r == s) ? mass : 0.0f;
      }
    }
    float* co = &out.cinert[((size_t)e * nb + b) * 36];
    for (int k = 0; k < 36; ++k) co[k] = ci[k];
  }
  for (int d = tid; d < nv; d += nt) {
    const int b = m.dof_bodyid[d], j = m.dof_jntid[d];
    const int kind = m.dof_kind[d], ax = m.dof_axis[d];
    float w[3] = {0.0f, 0.0f, 0.0f}, lin[3];
    if (kind == 2) {
      for (int k = 0; k < 3; ++k) w[k] = axis[j * 3 + k];
    } else if (kind == 1) {
      for (int k = 0; k < 3; ++k) w[k] = xmat[b * 9 + k * 3 + ax];
    }
    if (kind == 0) {
      for (int k = 0; k < 3; ++k) lin[k] = (k == ax) ? 1.0f : 0.0f;
    } else if (kind == 3) {
      for (int k = 0; k < 3; ++k) lin[k] = axis[j * 3 + k];
    } else {
      const float* org = &scom[m.body_rootid[b] * 3];
      float r[3];
      for (int k = 0; k < 3; ++k) r[k] = org[k] - anchor[j * 3 + k];
      lin[0] = w[1] * r[2] - w[2] * r[1];
      lin[1] = w[2] * r[0] - w[0] * r[2];
      lin[2] = w[0] * r[1] - w[1] * r[0];
    }
    float* cd = &cdof[d * 6];
    for (int k = 0; k < 3; ++k) { cd[k] = w[k]; cd[3 + k] = lin[k]; }
    float* co = &out.cdof[((size_t)e * nv + d) * 6];
    for (int k = 0; k < 6; ++k) co[k] = cd[k];
  }
  __syncthreads();

  // ---- composite rigid bodies: reverse-order subtree sums ----
  if (tid < 36) {
    for (int b = nb - 1; b > 0; --b) crb[m.body_parent[b] * 36 + tid] += crb[b * 36 + tid];
  }
  for (int i = tid; i < nv * nv; i += nt) A1[i] = 0.0f;
  __syncthreads();

  // ---- qM: each dof walks its parent-dof chain ----
  for (int i = tid; i < nv; i += nt) {
    const float* C = &crb[m.dof_bodyid[i] * 36];
    const float* cd = &cdof[i * 6];
    float F[6];
    for (int r = 0; r < 6; ++r) {
      float acc = 0.0f;
      for (int s = 0; s < 6; ++s) acc += C[r * 6 + s] * cd[s];
      F[r] = acc;
    }
    for (int j = i; j >= 0; j = m.dof_parent[j]) {
      const float* cj = &cdof[j * 6];
      float v = 0.0f;
      for (int r = 0; r < 6; ++r) v += F[r] * cj[r];
      if (j == i) v += m.armature[i];
      A1[i * nv + j] = v;
      A1[j * nv + i] = v;
    }
  }
  __syncthreads();

  // ---- write qM; set up the Jacobi-scaled sweep operands ----
  const int nmat = m.damped ? 2 : 1;
  for (int i = tid; i < nv * nv; i += nt) {
    out.qM[(size_t)e * nv * nv + i] = A1[i];
    if (m.damped) A2[i] = A1[i] + ((i / nv == i % nv) ? m.hB[i / nv] : 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < nmat * nv; i += nt) {
    const float* A = (i < nv) ? A1 : A2;
    const int r = i % nv;
    scl[i] = rsqrtf(fmaxf(A[r * nv + r], 1e-30f));
  }
  __syncthreads();
  for (int i = tid; i < nmat * nv * nv; i += nt) {
    const int mi = i / (nv * nv), r = (i / nv) % nv, s = i % nv;
    float* A = mi ? A2 : A1;
    A[r * nv + s] *= scl[mi * nv + r] * scl[mi * nv + s];
  }
  __syncthreads();

  // ---- symmetric sweep: after all pivots A holds -A^-1 ----
  for (int k = 0; k < nv; ++k) {
    for (int i = tid; i < nmat * nv; i += nt) {
      const int mi = i / nv, r = i % nv;
      const float* A = mi ? A2 : A1;
      col[i] = A[r * nv + k];
      row[i] = A[k * nv + r];
    }
    __syncthreads();
    for (int i = tid; i < nmat * nv * nv; i += nt) {
      const int mi = i / (nv * nv), r = (i / nv) % nv, s = i % nv;
      float* A = mi ? A2 : A1;
      const float dinv = 1.0f / row[mi * nv + k];
      const float v = col[mi * nv + r] - (r == k ? 1.0f : 0.0f);
      const float w = (row[mi * nv + s] - (s == k ? 1.0f : 0.0f)) * dinv;
      float a = A[r * nv + s] - v * w;
      if (r == k && s == k) a -= 2.0f;  // the rank-1 form over-counts by 2
      A[r * nv + s] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < nmat * nv * nv; i += nt) {
    const int mi = i / (nv * nv), r = (i / nv) % nv, s = i % nv;
    const float* A = mi ? A2 : A1;
    float* o = mi ? out.qMhBinv : out.qMinv;
    o[(size_t)e * nv * nv + r * nv + s] =
        -A[r * nv + s] * scl[mi * nv + r] * scl[mi * nv + s];
  }
}

extern "C" size_t position_smem_bytes(PosModel m) {
  const size_t n = (size_t)m.nq + (size_t)m.nb * (3 + 4 + 9 + 3 + 3 + 36) +
                   (size_t)m.nj * 6 + (size_t)m.nv * 6 +
                   2 * (size_t)m.nv * m.nv + 6 * (size_t)m.nv;
  return n * sizeof(float);
}

extern "C" int position_launch(PosModel m, const float* qpos, PosOut out,
                               int batch, int threads, void* stream) {
  const size_t smem = position_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      position_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  position_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(m, qpos,
                                                                   out);
  return (int)cudaGetLastError();
}
