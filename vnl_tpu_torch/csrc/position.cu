// Kernel A: the whole position stage of one physics substep, one thread
// block per env.
//
// Replaces the TPU kernel vnl_tpu/ops/pallas_position.py::_position_kernel
// (built by make_position_fused): qpos -> joint transforms, world poses,
// geom poses, subtree com, cinert, cdof, the CRB mass matrix qM (+armature)
// and, by a Jacobi-scaled symmetric sweep, qM^-1 and (qM + h diag(B))^-1.
//
// What bounds it on an H100: per env it reads nq floats and writes every
// output once (three nv x nv matrices dominate), and the two sweeps are
// 2 * 2 * nv^3 fp32 operations outside the tensor cores.  Both limits are
// far below what the dependent chains cost: nv pivot steps per sweep and the
// depth of the body tree in the walk.  The kernel is bound by the number of
// instructions the schedulers can start and by those chains, so the design
// shortens the chains and spends as few instructions as it can on every
// step of them.
//
// Design (the TPU layout, batch in lanes and tree gathers as one-hot
// matmuls, is not carried over):
//  * World poses by pointer doubling.  Every body first composes its own
//    joints into its pose in its parent's frame (all bodies at once, the
//    joint anchors and axes in that frame beside it); then
//    ceil(log2(depth)) rounds of X[b] <- X[anc[b]] . X[b], anc[b] <-
//    anc[anc[b]] bring every pose to the world frame, so a tree 35 bodies
//    deep costs 6 dependent steps, not 35.
//  * Subtree com and the composite inertias are sums over each body's
//    static descendant list, one thread per (body, component), in list
//    order: no step per tree level, no atomics, the same result on every
//    run.  qM is filled from the static list of (dof, ancestor dof) pairs.
//  * Two routes for the sweeps, by nv: up to 32 dofs one warp sweeps one
//    matrix, lane s holding column s (position_warp_kernel, below); wider
//    models take the register tiles of NW warps a matrix described next.
//  * Sweeps in registers.  Each matrix has its own NW warps.  Thread
//    (warp, lane) of a matrix owns its entries (r, s) = (warp + i * NW,
//    lane + 32 * j), i < TR, j < TC, for all pivots; TR and TC are template
//    constants, so the tile is unrolled and no entry pays index arithmetic,
//    and one tall tile per thread (not two short ones, one per matrix)
//    spreads the fixed cost of a pivot over twice the FMAs.  A warp's rows
//    keep their pivot-column entries in one of its own lanes, so the column
//    comes by TR shuffles; only the pivot row passes through shared memory:
//    the warp that owns row k+1 writes it, already shifted by e_k, and the
//    reciprocal of the pivot into the other half of a double buffer right
//    after its update.  A pivot so costs a thread TR shuffles, TC + 1
//    loads, TC multiplications, TR * TC FMAs and one barrier among the
//    matrix's own warps (a named barrier: the two sweeps drift apart and
//    fill each other's stalls).  Both the row and the column are taken as
//    they were before the update, which is not bitwise symmetric.  The
//    inverses leave straight from the tiles, neighbouring lanes on
//    neighbouring columns.
//  * Shared memory holds one nv x nv buffer, in which qM is assembled (and
//    which first carries the walk's second pose buffer, then the bodies'
//    cinert), the per-body and per-dof quantities and the pivot snapshots,
//    which come first so that their addresses are constants.
//  * Outputs leave as coalesced stores from shared memory.
// All arithmetic is fp32; the kernel allocates nothing and runs on the
// caller's stream.

#include <cuda_runtime.h>

#include "warp_sweep.cuh"

struct PosModel {
  int nb, nj, nv, nq, ng, damped, nrounds, npair;
  const int* body_parent;   // (nb)
  const int* body_jntadr;   // (nb)
  const int* body_jntnum;   // (nb)
  const int* body_rootid;   // (nb)
  const int* sub_start;     // (nb + 1) offsets into sub_body
  const int* sub_body;      // each body's subtree (itself first), ascending
  const int* jnt_type;      // (nj) 0 free, 1 ball, 2 slide, 3 hinge
  const int* jnt_qposadr;   // (nj)
  const int* geom_bodyid;   // (ng)
  const int* dof_bodyid;    // (nv)
  const int* dof_jntid;     // (nv)
  const int* anc_pair;      // (npair) (dof << 16) | ancestor-or-self dof
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

// Offsets (in floats) of the per-env quantities in dynamic shared memory.
// The pivot snapshots come first, so their addresses are compile-time
// constants of the tile.  The walk's temporaries (Walk) live in the matrix
// buffer, which nothing else touches before the walk is over.
struct Layout {
  int snap, qpos, xpos, xquat, xmat, xipos, scom, crb, anchor, axis, cdof,
      frc, mat, scl, total;
};

struct Walk {   // offsets from Layout.mat
  int pos2, quat2, anc, anc2, jframe, total;
};

__host__ __device__ inline Walk make_walk(const PosModel& m) {
  Walk W;
  int o = 0;
  W.pos2 = o;   o += m.nb * 3;   // second pose buffer of the doubling rounds
  W.quat2 = o;  o += m.nb * 4;
  W.anc = o;    o += m.nb;       // (int) the body a pose is relative to
  W.anc2 = o;   o += m.nb;
  W.jframe = o; o += m.nj;       // (int) the body a joint's anchor is
                                 // relative to; -1 - b: a free joint of b
  W.total = o;
  return W;
}

__host__ __device__ inline Layout make_layout(const PosModel& m, int cp,
                                              int nmat) {
  Layout L;
  int o = 0;
  // per matrix two buffers of: pivot row | 1 / pivot
  L.snap = o;   o += nmat * 2 * (cp + 1);
  L.qpos = o;   o += m.nq;
  L.xpos = o;   o += m.nb * 3;
  L.xquat = o;  o += m.nb * 4;
  L.xmat = o;   o += m.nb * 9;
  L.xipos = o;  o += m.nb * 3;
  L.scom = o;   o += m.nb * 3;
  L.crb = o;    o += m.nb * 36;
  L.anchor = o; o += m.nj * 3;
  L.axis = o;   o += m.nj * 3;
  L.cdof = o;   o += m.nv * 6;
  L.frc = o;    o += m.nv * 6;      // crb[body of dof] . cdof[dof]
  // the walk's temporaries, then cinert (nb, 36), then the matrix (nv, nv)
  int nmatbuf = m.nv * m.nv;
  if (m.nb * 36 > nmatbuf) nmatbuf = m.nb * 36;
  if (make_walk(m).total > nmatbuf) nmatbuf = make_walk(m).total;
  L.mat = o;    o += nmatbuf;
  L.scl = o;    o += 2 * m.nv;      // Jacobi scales of both matrices
  L.total = o;
  return L;
}

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

// Writes pivot kn's snapshot of one matrix from the register tile a, on the
// warp that owns row kn: A[kn,:] - e_kn (32 * TC floats) and 1 / A[kn,kn].
template <int NW, int TR, int TC>
__device__ __forceinline__ void publish_row(const float (&a)[TR][TC], int kn,
                                            int warp, int lane, float* nsnap) {
  if ((kn % NW) != warp) return;
  const int in = kn / NW;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (i == in) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int s = lane + 32 * j;
        const float x = a[i][j];
        nsnap[s] = (s == kn) ? x - 1.0f : x;
        if (s == kn) nsnap[32 * TC] = 1.0f / x;
      }
    }
  }
}

// The position stage of env e up to the sweeps, on the NT threads of its
// block, with its quantities at sm in the layout L.  Writes every output
// but the inverses and leaves qM in sm + L.mat and the Jacobi scales of the
// NMAT matrices in sm + L.scl.  skip: bits 1-3 as for position_kernel.
template <int NT, int NMAT>
__device__ __forceinline__ void stage_to_qM(const PosModel& m,
                                            const float* __restrict__ qpos_g,
                                            const PosOut& out, int skip,
                                            float* sm, const Layout& L, int e,
                                            int tid) {
  const int nb = m.nb, nj = m.nj, nv = m.nv, nq = m.nq, ng = m.ng;
  float* qpos = sm + L.qpos;
  float* xpos = sm + L.xpos;
  float* xquat = sm + L.xquat;
  float* xmat = sm + L.xmat;
  float* xipos = sm + L.xipos;
  float* scom = sm + L.scom;
  float* crb = sm + L.crb;
  float* anchor = sm + L.anchor;
  float* axis = sm + L.axis;
  float* cdof = sm + L.cdof;
  float* frc = sm + L.frc;
  float* A = sm + L.mat;
  float* cin = sm + L.mat;
  float* scl = sm + L.scl;

  const Walk W = make_walk(m);
  float* pos2 = sm + L.mat + W.pos2;
  float* quat2 = sm + L.mat + W.quat2;
  int* anc1 = reinterpret_cast<int*>(sm + L.mat + W.anc);
  int* anc2 = reinterpret_cast<int*>(sm + L.mat + W.anc2);
  int* jframe = reinterpret_cast<int*>(sm + L.mat + W.jframe);

  for (int i = tid; i < nq; i += NT) qpos[i] = qpos_g[(size_t)e * nq + i];
  __syncthreads();

  // ---- each body's pose in its parent's frame (in the world's below a
  // free joint), its joints' anchors and axes in that same frame ----
  const int nrounds = (skip & 4) ? 0 : m.nrounds;
  // the rounds alternate between the two pose buffers and end in xpos/xquat
  float* pa = (nrounds & 1) ? pos2 : xpos;
  float* qa4 = (nrounds & 1) ? quat2 : xquat;
  int* aa = (nrounds & 1) ? anc2 : anc1;
  float* pb = (nrounds & 1) ? xpos : pos2;
  float* qb4 = (nrounds & 1) ? xquat : quat2;
  int* ab = (nrounds & 1) ? anc1 : anc2;
  for (int b = tid; b < nb; b += NT) {
    float lp[3] = {0.0f, 0.0f, 0.0f}, lq[4] = {1.0f, 0.0f, 0.0f, 0.0f}, t[3];
    int frame = 0;
    if (b > 0) {
      frame = m.body_parent[b];
      for (int c = 0; c < 3; ++c) lp[c] = m.body_pos[b * 3 + c];
      for (int c = 0; c < 4; ++c) lq[c] = m.body_quat[b * 4 + c];
      const int j0 = m.body_jntadr[b], j1 = j0 + m.body_jntnum[b];
      for (int j = j0; j < j1; ++j) {
        const int qa = m.jnt_qposadr[j];
        const int type = m.jnt_type[j];
        const float* jp = &m.jnt_pos[j * 3];
        const float* ja = &m.jnt_axis[j * 3];
        if (type == 0) {  // free: the pose is the world's, whatever is above
          for (int c = 0; c < 3; ++c) lp[c] = qpos[qa + c];
          for (int c = 0; c < 4; ++c) lq[c] = qpos[qa + 3 + c];
          qnormalize(lq);
          frame = 0;
          for (int c = 0; c < 3; ++c) axis[j * 3 + c] = ja[c];
          jframe[j] = -1 - b;   // its anchor is the body's final position
          continue;
        }
        qnormalize(lq);  // frame before the joint
        qrot(lq, jp, t);
        for (int c = 0; c < 3; ++c) anchor[j * 3 + c] = lp[c] + t[c];
        qrot(lq, ja, &axis[j * 3]);
        jframe[j] = frame;
        float q[4], pl[3];
        if (type == 2) {  // slide
          const float scalar = qpos[qa] - m.qpos0[qa];
          q[0] = 1.0f; q[1] = q[2] = q[3] = 0.0f;
          for (int c = 0; c < 3; ++c) pl[c] = ja[c] * scalar;
        } else {
          if (type == 3) {  // hinge
            const float scalar = qpos[qa] - m.qpos0[qa];
            const float sn = sinf(0.5f * scalar);
            q[0] = cosf(0.5f * scalar);
            q[1] = ja[0] * sn; q[2] = ja[1] * sn; q[3] = ja[2] * sn;
          } else {  // ball
            for (int c = 0; c < 4; ++c) q[c] = qpos[qa + c];
            qnormalize(q);
          }
          qrot(q, jp, t);
          for (int c = 0; c < 3; ++c) pl[c] = jp[c] - t[c];
        }
        qrot(lq, pl, t);
        for (int c = 0; c < 3; ++c) lp[c] += t[c];
        float nq4[4];
        qmul(lq, q, nq4);
        for (int c = 0; c < 4; ++c) lq[c] = nq4[c];
      }
      qnormalize(lq);
    }
    for (int c = 0; c < 3; ++c) pa[b * 3 + c] = lp[c];
    for (int c = 0; c < 4; ++c) qa4[b * 4 + c] = lq[c];
    aa[b] = frame;
  }
  __syncthreads();

  // ---- world poses by pointer doubling: X[b] <- X[anc[b]] . X[b] ----
  for (int r = 0; r < nrounds; ++r) {
    for (int b = tid; b < nb; b += NT) {
      const int a = aa[b];
      float np[3], nq4[4];
      if (a == 0) {   // already in the world frame
        for (int c = 0; c < 3; ++c) np[c] = pa[b * 3 + c];
        for (int c = 0; c < 4; ++c) nq4[c] = qa4[b * 4 + c];
      } else {
        float t[3];
        qrot(&qa4[a * 4], &pa[b * 3], t);
        for (int c = 0; c < 3; ++c) np[c] = pa[a * 3 + c] + t[c];
        qmul(&qa4[a * 4], &qa4[b * 4], nq4);
        qnormalize(nq4);
      }
      for (int c = 0; c < 3; ++c) pb[b * 3 + c] = np[c];
      for (int c = 0; c < 4; ++c) qb4[b * 4 + c] = nq4[c];
      ab[b] = a == 0 ? 0 : aa[a];
    }
    __syncthreads();
    float* tp = pa; pa = pb; pb = tp;
    float* tq = qa4; qa4 = qb4; qb4 = tq;
    int* ta = aa; aa = ab; ab = ta;
  }

  // ---- joint anchors and axes into the world frame ----
  for (int j = tid; j < nj; j += NT) {
    const int f = jframe[j];
    if (f < 0) {
      for (int c = 0; c < 3; ++c) anchor[j * 3 + c] = xpos[(-1 - f) * 3 + c];
    } else if (f > 0) {
      float t[3], u[3];
      qrot(&xquat[f * 4], &anchor[j * 3], t);
      qrot(&xquat[f * 4], &axis[j * 3], u);
      for (int c = 0; c < 3; ++c) {
        anchor[j * 3 + c] = xpos[f * 3 + c] + t[c];
        axis[j * 3 + c] = u[c];
      }
    }
  }

  // ---- per-body frames, geoms, joints ----
  for (int b = tid; b < nb; b += NT) {
    q2mat(&xquat[b * 4], &xmat[b * 9]);
    float t[3];
    qrot(&xquat[b * 4], &m.body_ipos[b * 3], t);
    for (int c = 0; c < 3; ++c) xipos[b * 3 + c] = xpos[b * 3 + c] + t[c];
  }
  for (int g = tid; g < ng; g += NT) {
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
  __syncthreads();
  for (int i = tid; i < nj * 3; i += NT) {
    out.xanchor[(size_t)e * nj * 3 + i] = anchor[i];
    out.xaxis[(size_t)e * nj * 3 + i] = axis[i];
  }

  // ---- subtree com: each (body, axis) sums its descendant list ----
  for (int it = tid; it < nb * 3; it += NT) {
    const int b = it / 3, c = it - b * 3;
    const int lo = m.sub_start[b];
    const int hi = (skip & 2) ? lo + 1 : m.sub_start[b + 1];
    float acc = 0.0f;
    for (int t = lo; t < hi; ++t) {
      const int d = m.sub_body[t];
      acc += m.body_mass[d] * xipos[d * 3 + c];
    }
    scom[it] = acc / m.subtree_mass[b];
  }
  for (int i = tid; i < nb * 3; i += NT) {
    out.xpos[(size_t)e * nb * 3 + i] = xpos[i];
    out.xipos[(size_t)e * nb * 3 + i] = xipos[i];
  }
  for (int i = tid; i < nb * 4; i += NT)
    out.xquat[(size_t)e * nb * 4 + i] = xquat[i];
  for (int i = tid; i < nb * 9; i += NT)
    out.xmat[(size_t)e * nb * 9 + i] = xmat[i];
  __syncthreads();
  for (int i = tid; i < nb * 3; i += NT)
    out.subtree_com[(size_t)e * nb * 3 + i] = scom[i];

  // ---- cinert about each body's root subtree com; cdof ----
  for (int b = tid; b < nb; b += NT) {
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
    const float cx[9] = {0.0f, -c[2], c[1], c[2], 0.0f, -c[0],
                         -c[1], c[0], 0.0f};
    float* ci = &cin[b * 36];
    for (int r = 0; r < 3; ++r) {
      for (int s = 0; s < 3; ++s) {
        float ic = R[r * 3 + 0] * I[0] * R[s * 3 + 0] +
                   R[r * 3 + 1] * I[1] * R[s * 3 + 1] +
                   R[r * 3 + 2] * I[2] * R[s * 3 + 2];
        ci[r * 6 + s] = ic + mass * ((r == s ? cc : 0.0f) - c[r] * c[s]);
        ci[r * 6 + s + 3] = mass * cx[r * 3 + s];
        ci[(r + 3) * 6 + s] = mass * cx[s * 3 + r];
        ci[(r + 3) * 6 + s + 3] = (r == s) ? mass : 0.0f;
      }
    }
  }
  for (int d = tid; d < nv; d += NT) {
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
  }
  __syncthreads();

  // ---- composite rigid bodies: each (body, entry) sums its descendants ----
  for (int i = tid; i < nb * 36; i += NT)
    out.cinert[(size_t)e * nb * 36 + i] = cin[i];
  for (int i = tid; i < nv * 6; i += NT)
    out.cdof[(size_t)e * nv * 6 + i] = cdof[i];
  for (int it = tid; it < nb * 36; it += NT) {
    const int b = it / 36, k = it - b * 36;
    const int lo = m.sub_start[b];
    const int hi = (skip & 2) ? lo + 1 : m.sub_start[b + 1];
    float acc = 0.0f;
    for (int t = lo; t < hi; ++t) acc += cin[m.sub_body[t] * 36 + k];
    crb[it] = acc;
  }
  __syncthreads();

  // ---- qM: crb . cdof per dof, then one entry per (dof, ancestor) pair ----
  for (int i = tid; i < nv * nv; i += NT) A[i] = 0.0f;
  for (int it = tid; it < nv * 6; it += NT) {
    const int i = it / 6, r = it - i * 6;
    const float* C = &crb[m.dof_bodyid[i] * 36 + r * 6];
    const float* cd = &cdof[i * 6];
    float acc = 0.0f;
    for (int s = 0; s < 6; ++s) acc += C[s] * cd[s];
    frc[it] = acc;
  }
  __syncthreads();
  const int npair = (skip & 8) ? 0 : m.npair;
  for (int t = tid; t < npair; t += NT) {
    const int pk = m.anc_pair[t];
    const int i = pk >> 16, j = pk & 0xffff;
    const float* F = &frc[i * 6];
    const float* cj = &cdof[j * 6];
    float v = 0.0f;
    for (int r = 0; r < 6; ++r) v += F[r] * cj[r];
    if (j == i) v += m.armature[i];
    A[i * nv + j] = v;
    A[j * nv + i] = v;
  }
  __syncthreads();

  // ---- write qM; Jacobi scales of qM and qM + h diag(B) ----
  for (int i = tid; i < nv * nv; i += NT)
    out.qM[(size_t)e * nv * nv + i] = A[i];
  for (int i = tid; i < NMAT * nv; i += NT) {
    const int mi = i >= nv, r = i - mi * nv;
    const float d = A[r * nv + r] + (mi ? m.hB[r] : 0.0f);
    scl[i] = rsqrtf(fmaxf(d, 1e-30f));
  }
  __syncthreads();
}

// NW warps sweep one matrix; the block has NW * NMAT warps.
// skip (profiling only, the outputs are then wrong): bit 0 leaves out the
// pivot loop, bit 1 cuts the subtree sums to each body's own term, bit 2
// leaves out the doubling rounds of the walk, bit 3 the assembly of qM.
template <int NW, int TR, int TC, int NMAT>
__global__ void __launch_bounds__(NW * NMAT * 32, 2)
position_kernel(PosModel m, const float* __restrict__ qpos_g, PosOut out,
                int skip) {
  extern __shared__ float sm[];
  constexpr int CP = 32 * TC, NT = NW * NMAT * 32;
  constexpr int SNAP = CP + 1;   // one pivot snapshot: row | 1 / pivot
  const int nv = m.nv;
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const Layout L = make_layout(m, CP, NMAT);
  stage_to_qM<NT, NMAT>(m, qpos_g, out, skip, sm, L, e, tid);
  const float* A = sm + L.mat;
  const float* scl = sm + L.scl;
  float* snap = sm;   // Layout.snap is 0: constant addresses in the sweep

  // ---- my matrix, scaled, into my register tile ----
  const int mi = (NMAT == 1) ? 0 : warp / NW;   // which matrix my warp sweeps
  const int wr = warp - mi * NW;                // my warp among its NW
  const float* myscl = scl + mi * nv;
  float a[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int r = wr + i * NW, s = lane + 32 * j;
      float x = 0.0f;
      if (r < nv && s < nv) {
        x = A[r * nv + s];
        if (mi == 1 && r == s) x += m.hB[r];
        x *= myscl[r] * myscl[s];
      }
      a[i][j] = x;
    }
  }

  // ---- symmetric sweep: after all pivots a holds -A^-1 (scaled) ----
  // for pivot k, with column and row k as they were before the update:
  //   v = A[:,k] - e_k,  w = (A[k,:] - e_k) / A[k,k],
  //   A <- A - v w^T,    A[k,k] <- A[k,k] - 2
  // Column k of my rows lies in my own warp, in lane k % 32 of tile column
  // k / 32: a shuffle brings it, and the pivots are walked in chunks of 32
  // so that the tile column is a constant.  Row k comes through shared
  // memory: the warp that owns row k+1 publishes it (and 1 / pivot) into
  // the other buffer right after its update; everyone else only reads.
  float* mysnap = snap + mi * 2 * SNAP;
  publish_row<NW, TR, TC>(a, 0, wr, lane, mysnap);
  __syncthreads();   // the last barrier of the whole block

  const int npiv = (skip & 1) ? 0 : nv;
#pragma unroll
  for (int jk = 0; jk < TC; ++jk) {
    const int kend = npiv < 32 * (jk + 1) ? npiv : 32 * (jk + 1);
#pragma unroll 1
    for (int k = 32 * jk; k < kend; ++k) {
      const float* cur = mysnap + (k & 1) * SNAP;
      const float dinv = cur[CP];
      float v[TR], w[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) w[j] = cur[lane + 32 * j] * dinv;
#pragma unroll
      for (int i = 0; i < TR; ++i)
        v[i] = __shfl_sync(0xffffffffu, a[i][jk], k & 31);
      const bool myrow = (k % NW) == wr;
      if (myrow) {
        const int ik = k / NW;
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (i == ik) v[i] -= 1.0f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < TC; ++j) a[i][j] -= v[i] * w[j];
      }
      if (myrow && (k & 31) == lane) {
        // the rank-1 form over-counts the pivot entry by 2
        const int ik = k / NW;
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (i == ik) a[i][jk] -= 2.0f;
      }
      if (k + 1 < nv)
        publish_row<NW, TR, TC>(a, k + 1, wr, lane,
                                mysnap + ((k + 1) & 1) * SNAP);
      if (NMAT == 1) {
        __syncthreads();
      } else {   // only the NW warps of this matrix
        asm volatile("bar.sync %0, %1;" ::"r"(1 + mi), "n"(NW * 32)
                     : "memory");
      }
    }
  }

  // ---- sign and unscale; neighbouring lanes store neighbouring columns ----
  // (the indices pass through an empty asm so that nothing computed for the
  // tile load is kept alive, and spilled, across the sweep for reuse here)
  int wr2 = wr, lane2 = lane;
  asm volatile("" : "+r"(wr2), "+r"(lane2));
  float* o = (mi ? out.qMhBinv : out.qMinv) + (size_t)e * nv * nv;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int r = wr2 + i * NW, s = lane2 + 32 * j;
      if (r < nv && s < nv) o[r * nv + s] = -a[i][j] * myscl[r] * myscl[s];
    }
  }
}

// ---------------------------------------------------------------------------
// The route for nv <= 32: one warp sweeps one matrix, with no barrier.
// Below 32 dofs the tiles above are mostly padding (nv 14 and 27 take the
// twin's (10, 3): 8 warps a matrix for 96 columns) and every pivot costs
// a named barrier over 8 warps.  Here lane s owns column s and holds all T
// rows of it in registers (T = 16 or 32, the pivot loop unrolled, so every
// row index is a constant); for pivot k the column entries (r, k) come by
// shuffles from lane k and the pivot row entry is the lane's own register.
// A block is one env of NMAT warps, which also run its walk, sums and qM
// assembly (stage_to_qM on 32 NMAT threads): all 1024 envs are resident at
// once on 132 SMs.  Blocks of 2 and 4 envs (named barriers per env) took
// the same time on the humanoid and the ant (PERF.md).
// ---------------------------------------------------------------------------
template <int T, int NMAT>
__global__ void __launch_bounds__(NMAT * 32)
position_warp_kernel(PosModel m, const float* __restrict__ qpos_g, PosOut out,
                     int skip) {
  extern __shared__ float sm[];
  constexpr int NT = NMAT * 32;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, mi = tid >> 5;   // which matrix my warp sweeps
  const int nv = m.nv;

  const Layout L = make_layout(m, 0, NMAT);
  stage_to_qM<NT, NMAT>(m, qpos_g, out, skip, sm, L, e, tid);
  const float* A = sm + L.mat;
  const float* myscl = sm + L.scl + mi * nv;

  // ---- column `lane` of my matrix, scaled, into registers ----
  const bool col = lane < nv;
  const float sc = col ? myscl[lane] : 0.0f;
  float a[T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
    float x = 0.0f;
    if (r < nv && col) {
      x = A[r * nv + lane];
      if (mi == 1 && r == lane) x += m.hB[r];
      x *= myscl[r] * sc;
    }
    a[r] = x;
  }

  // ---- symmetric sweep (as in position_kernel; warp_sweep.cuh) ----
  warp_sweep<T>(a, (skip & 1) ? 0 : nv, lane);

  // ---- sign and unscale; neighbouring lanes store neighbouring columns ----
  float* o = (mi ? out.qMhBinv : out.qMinv) + (size_t)e * nv * nv;
#pragma unroll
  for (int r = 0; r < T; ++r)
    if (r < nv && col) o[r * nv + lane] = -a[r] * myscl[r] * sc;
}

typedef void (*PositionKernel)(PosModel, const float*, PosOut, int);

constexpr int kWarps = 8;   // warps that sweep one matrix

// The instantiated tiles: (TR, TC) covers nv <= min(kWarps * TR, 32 * TC);
// a tile with TC = 1 is the one-warp route (one warp a matrix, TR rows a
// lane), which covers nv <= TR.  ops/position.py lists the same shapes
// (TILE_SHAPES) and chooses.
static PositionKernel pick_kernel(int tr, int tc, int nmat) {
#define TILE(TR, TC)                                          \
  if (tr == TR && tc == TC)                                   \
    return nmat == 2 ? position_kernel<kWarps, TR, TC, 2>     \
                     : position_kernel<kWarps, TR, TC, 1>;
  TILE(10, 3)
  TILE(12, 3)
#undef TILE
  return nullptr;
}

static PositionKernel pick_warp_kernel(int tr, int tc, int nmat) {
#define WARP_TILE(T)                                                  \
  if (tr == T && tc == 1)                                             \
    return nmat == 2 ? position_warp_kernel<T, 2>                     \
                     : position_warp_kernel<T, 1>;
  WARP_TILE(16)
  WARP_TILE(32)
#undef WARP_TILE
  return nullptr;
}

static size_t smem_bytes(const PosModel& m, int tc) {
  return (size_t)make_layout(m, tc == 1 ? 0 : 32 * tc, m.damped ? 2 : 1)
             .total * sizeof(float);
}

// The kernel of a tile and its threads per block; nullptr where the tile
// is not instantiated or does not cover the model.
static PositionKernel route(const PosModel& m, int tr, int tc, int* threads) {
  const int nmat = m.damped ? 2 : 1;
  if (m.nv > 0xffff) return nullptr;
  if (tc == 1) {
    *threads = nmat * 32;
    PositionKernel fn = pick_warp_kernel(tr, tc, nmat);
    return m.nv <= tr ? fn : nullptr;
  }
  *threads = kWarps * nmat * 32;
  PositionKernel fn = pick_kernel(tr, tc, nmat);
  return (m.nv <= kWarps * tr && m.nv <= 32 * tc) ? fn : nullptr;
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int position_resources(PosModel m, int tr, int tc, int* out4) {
  int threads = 0;
  PositionKernel fn = route(m, tr, tc, &threads);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(m, tc);
  err = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)fn, threads, smem);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)(smem + a.sharedSizeBytes);
  out4[3] = blocks;
  return (int)err;
}

extern "C" int position_launch(PosModel m, const float* qpos, PosOut out,
                               int batch, int tr, int tc, void* stream,
                               int skip) {
  int threads = 0;
  PositionKernel fn = route(m, tr, tc, &threads);
  if (!fn) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, tc);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<batch, threads, smem, (cudaStream_t)stream>>>(m, qpos, out, skip);
  return (int)cudaGetLastError();
}
