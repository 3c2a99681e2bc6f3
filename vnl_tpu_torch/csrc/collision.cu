// Kernel E: the narrowphase of every candidate pair of a substep, all pair
// types, in one launch; one thread per (env, candidate pair).
//
// Replaces no TPU kernel: the JAX package leaves vnl_tpu/physics/
// collision.py collide to XLA's fusions.  On the card the plain version
// (physics/collision.py collide_plain) is a chain of small elementwise,
// gather and einsum launches, one group of them per pair type: at the
// dm_control humanoid's 161 pairs in five groups about 283 a substep,
// each over a tensor of a few thousand floats.  Its outputs are the
// contacts as collide returns them:
//   dist (B, ncon), pos (B, ncon, 3), frame (B, ncon, 3, 3) (rows normal,
//   tangent 1, tangent 2),
// with point j of pair i of a pair group in slot first_i + j * stride_i
// (ops/collision.py derives both from pair_expansion).
//
// What bounds it on an H100: per env it reads the position and rotation
// of each geom that a pair names (12 floats) and writes 13 floats a
// contact slot: at the humanoid's 177 slots about 9.2 KB an env, 1.2 MB at
// 128 envs, under half a microsecond against 3.35 TB/s.  The arithmetic is
// tens to a few hundred operations a pair.  So a launch costs its
// latency, and the design keeps it one short pass: no shared memory, no
// barrier, every pair's points computed in registers and written once.
//
// Design:
//  * Thread index env * npair + pair, 128 threads a block.  Pairs come in
//    the plain version's group order (collision._ORDER), so the threads of
//    a warp mostly take one pair type.
//  * Per pair a static table, built once per model: its type, both geom
//    ids, its first slot and slot stride, and both geoms' sizes.
//  * Each pair type follows the plain version's formulas term for term,
//    in float32, each product, sum and quotient rounded on its own (the
//    source is built with -fmad=false, ops/build.py FLAGS) and sums of
//    three terms taken left to right, as the plain version's separate
//    PyTorch operations on the CPU take them.  Where two capsules' axes
//    nearly meet, the contact normal is the quotient of a short difference
//    and its norm, and a fused multiply-add there (or the plain version on
//    the card, whose reduction kernel sums three terms as (a + c) + b)
//    moves the frame by up to 8e-5.  Plane-box keeps its 4 deepest
//    corners and box-box its 8 deepest of 25 candidates as the plain
//    version's stable sort does: a candidate's slot is its rank, ties
//    ranked in index order.
//  * Box pairs are a template branch (kBoxes): their selection would raise
//    the register count of every scene, and only scenes with boxes
//    take the instantiation that has them (ops/collision.py picks it).
//  * Every slot is written every step, active or not: activity is carried
//    by the sign of dist downstream.
// fp32 throughout; the kernel allocates nothing and runs on the caller's
// stream.

#include <cuda_runtime.h>

struct ColModel {
  int npair, ngeom, ncon;
  const int* pair_int;      // (kPairI, npair), fields below
  const float* pair_size;   // (6, npair): size of geom 1, then of geom 2
};

struct ColIn {
  const float *geom_xpos, *geom_xmat;   // (B, ngeom, 3), (B, ngeom, 3, 3)
};

struct ColOut {
  float *dist, *pos, *frame;            // (B, ncon), (.., 3), (.., 3, 3)
};

// the fields of pair_int (ops/collision.py PAIR_FIELDS)
enum PairI { kType, kG1, kG2, kSlot, kStride, kPairI };

// pair types, in collision._ORDER's order (ops/collision.py PAIR_TYPES)
enum PairType { kPlaneSphere, kPlaneCapsule, kPlaneEllipsoid, kPlaneCylinder,
                kPlaneBox, kSphereSphere, kSphereCapsule, kCapsuleCapsule,
                kSphereBox, kBoxBox };

constexpr int kThreads = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return v3(s * a.x, s * a.y, s * a.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {       // elementwise
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {     // math.cross
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 vabs(V3 a) {
  return v3(fabsf(a.x), fabsf(a.y), fabsf(a.z));
}
__device__ __forceinline__ float comp(V3 a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : a.z);
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

// torch.clamp(x, min=lo), torch.clamp(x, lo, hi): NaN in, NaN out
__device__ __forceinline__ float cmin(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
// torch.sign
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// a rotation, row-major as geom_xmat holds it
struct M3 {
  float a[9];
};

__device__ __forceinline__ V3 col(const M3& R, int j) {
  return v3(R.a[j], R.a[3 + j], R.a[6 + j]);
}
__device__ __forceinline__ V3 mulv(const M3& R, V3 v) {     // R v
  return v3(R.a[0] * v.x + R.a[1] * v.y + R.a[2] * v.z,
            R.a[3] * v.x + R.a[4] * v.y + R.a[5] * v.z,
            R.a[6] * v.x + R.a[7] * v.y + R.a[8] * v.z);
}
__device__ __forceinline__ V3 mulTv(const M3& R, V3 v) {    // R^T v
  return v3(R.a[0] * v.x + R.a[3] * v.y + R.a[6] * v.z,
            R.a[1] * v.x + R.a[4] * v.y + R.a[7] * v.z,
            R.a[2] * v.x + R.a[5] * v.y + R.a[8] * v.z);
}

struct Frame {
  V3 r[3];
};

// _plane_frame: rows z, x, y of the plane's rotation
__device__ __forceinline__ Frame plane_frame(const M3& R) {
  return Frame{{col(R, 2), col(R, 0), col(R, 1)}};
}

// _make_frame: rows n, t1, t2 with t1 from the z axis (or x where n is
// near z)
__device__ Frame make_frame(V3 n) {
  const V3 a = fabsf(n.z) < 0.9f ? v3(0.f, 0.f, 1.f) : v3(1.f, 0.f, 0.f);
  V3 t1 = cross(a, n);
  const float inv = cmin(norm(t1), 1e-12f);
  t1 = v3(t1.x / inv, t1.y / inv, t1.z / inv);
  return Frame{{n, t1, cross(n, t1)}};
}

struct Env {
  const float* xpos;    // (ngeom, 3) of this env
  const float* xmat;    // (ngeom, 9)
  __device__ V3 pos(int g) const {
    return v3(xpos[3 * g], xpos[3 * g + 1], xpos[3 * g + 2]);
  }
  __device__ M3 mat(int g) const {
    M3 R;
#pragma unroll
    for (int i = 0; i < 9; ++i) R.a[i] = xmat[9 * g + i];
    return R;
  }
};

struct Slots {
  float *dist, *pos, *frame;   // this env's rows of the outputs
  int first, stride;
  __device__ void put(int j, float d, V3 p, const Frame& f) const {
    const int s = first + j * stride;
    dist[s] = d;
    pos[3 * s] = p.x;
    pos[3 * s + 1] = p.y;
    pos[3 * s + 2] = p.z;
    float* o = frame + 9 * s;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      o[3 * r] = f.r[r].x;
      o[3 * r + 1] = f.r[r].y;
      o[3 * r + 2] = f.r[r].z;
    }
  }
};

// _plane_sphere: a sphere (c, r) against the plane (p, normal n)
__device__ __forceinline__ void plane_sphere(V3 p, V3 n, V3 c, float r,
                                             float& dist, V3& pos) {
  dist = dot(n, c - p) - r;
  pos = c - (r + 0.5f * dist) * n;
}

// _segpoint: the closest point to p on [a0, a1]
__device__ __forceinline__ V3 segpoint(V3 p, V3 a0, V3 a1) {
  const V3 ab = a1 - a0;
  const float t = dot(p - a0, ab) / cmin(dot(ab, ab), 1e-12f);
  return a0 + clip(t, 0.f, 1.f) * ab;
}

// _spheres: spheres (c1, r1) and (c2, r2), one point, normal 1 -> 2
__device__ void spheres(const Slots& out, V3 c1, float r1, V3 c2, float r2) {
  const V3 delta = c2 - c1;
  const float dn = cmin(norm(delta), 1e-12f);
  const V3 n = v3(delta.x / dn, delta.y / dn, delta.z / dn);
  const float dist = dn - (r1 + r2);
  out.put(0, dist, c1 + (r1 + 0.5f * dist) * n, make_frame(n));
}

// the ranks of the stable ascending sort of d (ties in index order)
template <int N>
__device__ __forceinline__ void ranks(const float (&d)[N], int (&rank)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      r += (d[j] < d[i] || (d[j] == d[i] && j < i)) ? 1 : 0;
    rank[i] = r;
  }
}

// the 8 corners' sign patterns, x slowest (collision._CORNER_SIGNS)
__device__ __forceinline__ V3 corner(int c) {
  return v3((c & 4) ? 1.f : -1.f, (c & 2) ? 1.f : -1.f,
            (c & 1) ? 1.f : -1.f);
}

// _pp_box: the four deepest corners against the plane
__device__ void plane_box(const Slots& out, V3 x1, const M3& R1, V3 x2,
                          const M3& R2, V3 s2) {
  const V3 n = col(R1, 2);
  const Frame f = plane_frame(R1);
  float d[8];
  int rank[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    d[c] = dot(n, x2 + mulv(R2, mul(corner(c), s2)) - x1);
  ranks(d, rank);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (rank[c] < 4)
      out.put(rank[c], d[c],
              x2 + mulv(R2, mul(corner(c), s2)) - (0.5f * d[c]) * n, f);
}

// _sphere_box: the sphere (c, r) against the box (bp, bR, bs)
__device__ void sphere_box(const Slots& out, V3 c, float r, V3 bp,
                           const M3& bR, V3 bs) {
  const V3 local = mulTv(bR, c - bp);
  const V3 clamped = v3(clip(local.x, -bs.x, bs.x),
                        clip(local.y, -bs.y, bs.y),
                        clip(local.z, -bs.z, bs.z));
  const V3 delta = local - clamped;
  const float dn = norm(delta);
  const bool outside = dn > 1e-9f;
  const V3 face = bs - vabs(local);
  int k = 0;                                 // argmin, first of ties
  float fmin = face.x;
  if (face.y < fmin) { k = 1; fmin = face.y; }
  if (face.z < fmin) { k = 2; fmin = face.z; }
  V3 n_local;
  float dist;
  if (outside) {
    const float inv = cmin(dn, 1e-12f);
    n_local = v3(delta.x / inv, delta.y / inv, delta.z / inv);
    dist = dn - r;
  } else {
    const float s = sgnf(comp(local, k));
    n_local = v3(k == 0 ? -s : -0.f * s, k == 1 ? -s : -0.f * s,
                 k == 2 ? -s : -0.f * s);
    dist = -(fmin + r);
  }
  const V3 n = -mulv(bR, n_local);
  const V3 surf = bp + mulv(bR, clamped);
  out.put(0, dist, surf + (0.5f * dist) * n, make_frame(n));
}

// _seg_closest: closest points of the segments p0 +- h0 d0, p1 +- h1 d1
__device__ void seg_closest(V3 p0, V3 d0, float h0, V3 p1, V3 d1, float h1,
                            V3& q0, V3& q1) {
  const V3 r = p1 - p0;
  const float a = dot(d0, d0), e = dot(d1, d1), f = dot(d1, r),
              c = dot(d0, r), b = dot(d0, d1);
  const float den = cmin(a * e - b * b, 1e-12f);
  float s = clip((b * f - c * e) / -den, -h0, h0);
  const float u = clip((b * s + f) / cmin(e, 1e-12f), -h1, h1);
  s = clip((b * u + c) / cmin(a, 1e-12f), -h0, h0);
  q0 = p0 + s * d0;
  q1 = p1 + u * d1;
}

// _box_box: SAT over the 15 axes, 25 candidates, the 8 deepest kept
__device__ void box_box(const Slots& out, V3 pa, const M3& Ra, V3 sa, V3 pb,
                        const M3& Rb, V3 sb) {
  M3 R;                                      // B's axes in A's frame
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      R.a[3 * i + k] = Ra.a[i] * Rb.a[k] + Ra.a[3 + i] * Rb.a[3 + k] +
                       Ra.a[6 + i] * Rb.a[6 + k];
  const V3 t = mulTv(Ra, pb - pa);
  const V3 ex = v3(1.f, 0.f, 0.f), ey = v3(0.f, 1.f, 0.f),
           ez = v3(0.f, 0.f, 1.f);
  float depth[15], tl[15];
  V3 axes[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    V3 ax;
    if (k < 3) {
      ax = k == 0 ? ex : (k == 1 ? ey : ez);
    } else if (k < 6) {
      ax = col(R, k - 3);
    } else {
      const int i = (k - 6) / 3, j = (k - 6) % 3;
      ax = cross(i == 0 ? ex : (i == 1 ? ey : ez), col(R, j));
    }
    const float an = cmin(norm(ax), 1e-12f);
    ax = v3(ax.x / an, ax.y / an, ax.z / an);
    axes[k] = ax;
    const float ra = dot(vabs(ax), sa);
    const V3 proj = mulTv(R, ax);            // proj_j = sum_i ax_i R_ij
    const float rb = dot(vabs(proj), sb);
    tl[k] = dot(ax, t);
    depth[k] = (k < 6 || an > 1e-6f) ? ra + rb - fabsf(tl[k]) : INFINITY;
  }
  int kmin = 0;                              // argmin, first of ties
  float min_depth = depth[0];
#pragma unroll
  for (int k = 1; k < 15; ++k)
    if (depth[k] < min_depth) { kmin = k; min_depth = depth[k]; }
  V3 lmin = axes[0];
  float tmin = tl[0];
#pragma unroll
  for (int k = 1; k < 15; ++k)
    if (k == kmin) { lmin = axes[k]; tmin = tl[k]; }
  float sgn = sgnf(tmin);
  sgn = sgn == 0.f ? 1.f : sgn;
  const V3 nA = sgn * lmin;                  // A's frame, A -> B
  const V3 n = mulv(Ra, nA);
  const float ra_n = dot(vabs(nA), sa);
  const V3 nB = mulTv(R, nA);                // n in B's frame
  const float rb_n = dot(vabs(nB), sb);

  float d[25];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    d[c] = dot(n, pb + mulv(Rb, mul(corner(c), sb)) - pa) - ra_n;
    d[8 + c] = -dot(n, pa + mulv(Ra, mul(corner(c), sa)) - pb) - rb_n;
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) d[16 + e] = kmin == 6 + e ? -min_depth : 1e3f;
  int rank[25];
  ranks(d, rank);

  const Frame f = make_frame(n);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (rank[c] < 8) {
      const V3 cb = pb + mulv(Rb, mul(corner(c), sb));
      out.put(rank[c], d[c], cb - (0.5f * d[c]) * n, f);
    }
    if (rank[8 + c] < 8) {
      const V3 ca = pa + mulv(Ra, mul(corner(c), sa));
      out.put(rank[8 + c], d[8 + c], ca + (0.5f * d[8 + c]) * n, f);
    }
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    if (rank[16 + e] >= 8) continue;
    const int i = e / 3, j = e % 3;
    const V3 lk = sgn * axes[6 + e];
    const V3 oa = v3(i == 0 ? 0.f : sa.x * sgnf(lk.x + 1e-12f),
                     i == 1 ? 0.f : sa.y * sgnf(lk.y + 1e-12f),
                     i == 2 ? 0.f : sa.z * sgnf(lk.z + 1e-12f));
    const V3 ob = v3(j == 0 ? 0.f : sb.x * -sgnf(nB.x + 1e-12f),
                     j == 1 ? 0.f : sb.y * -sgnf(nB.y + 1e-12f),
                     j == 2 ? 0.f : sb.z * -sgnf(nB.z + 1e-12f));
    V3 q0, q1;
    seg_closest(pa + mulv(Ra, oa), col(Ra, i), comp(sa, i),
                pb + mulv(Rb, ob), col(Rb, j), comp(sb, j), q0, q1);
    out.put(rank[16 + e], d[16 + e], 0.5f * (q0 + q1), f);
  }
}

template <bool kBoxes>
__global__ void __launch_bounds__(kThreads)
collision_kernel(ColModel m, ColIn in, ColOut out, int batch) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= batch * m.npair) return;
  const int b = idx / m.npair, p = idx - b * m.npair;
  const int np = m.npair;
  const int type = m.pair_int[kType * np + p];
  const int g1 = m.pair_int[kG1 * np + p], g2 = m.pair_int[kG2 * np + p];
  const float* sz = m.pair_size + p;
  const V3 s1 = v3(sz[0], sz[np], sz[2 * np]);
  const V3 s2 = v3(sz[3 * np], sz[4 * np], sz[5 * np]);
  const Env env{in.geom_xpos + (size_t)b * m.ngeom * 3,
                in.geom_xmat + (size_t)b * m.ngeom * 9};
  const size_t row = (size_t)b * m.ncon;
  const Slots slots{out.dist + row, out.pos + 3 * row, out.frame + 9 * row,
                    m.pair_int[kSlot * np + p], m.pair_int[kStride * np + p]};
  const V3 x1 = env.pos(g1), x2 = env.pos(g2);

  switch (type) {
    case kPlaneSphere: {
      const M3 R1 = env.mat(g1);
      float dist;
      V3 pos;
      plane_sphere(x1, col(R1, 2), x2, s2.x, dist, pos);
      slots.put(0, dist, pos, plane_frame(R1));
      break;
    }
    case kPlaneCapsule: {                    // the two endpoint spheres
      const M3 R1 = env.mat(g1), R2 = env.mat(g2);
      const V3 axis = col(R2, 2);
      const Frame f = plane_frame(R1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float dist;
        V3 pos;
        plane_sphere(x1, col(R1, 2), x2 + s2.y * ((j ? -1.f : 1.f) * axis),
                     s2.x, dist, pos);
        slots.put(j, dist, pos, f);
      }
      break;
    }
    case kPlaneEllipsoid: {                  // one support point
      const M3 R1 = env.mat(g1), R2 = env.mat(g2);
      const V3 n = col(R1, 2);
      const V3 sn = mul(s2, mulTv(R2, n));
      const float den = cmin(norm(sn), 1e-12f);
      const V3 ss = mul(s2, sn);
      const V3 pt = x2 + mulv(R2, v3(-ss.x / den, -ss.y / den, -ss.z / den));
      const float dist = dot(n, pt - x1);
      slots.put(0, dist, pt - (0.5f * dist) * n, plane_frame(R1));
      break;
    }
    case kPlaneCylinder: {                   // four rim points
      const M3 R1 = env.mat(g1), R2 = env.mat(g2);
      const V3 n = col(R1, 2), axis = col(R2, 2);
      const float r = s2.x, h = s2.y;
      const float cosa = dot(n, axis);
      const V3 u_raw = cosa * axis - n;
      const float sina = norm(u_raw);
      const float inv = cmin(sina, 1e-12f);
      const V3 u = sina > 1e-6f ? v3(u_raw.x / inv, u_raw.y / inv,
                                     u_raw.z / inv)
                                : col(R2, 0);
      const V3 v = cross(axis, u);
      const V3 u120 = -0.5f * u + 0.8660254f * v;
      const V3 u240 = -0.5f * u - 0.8660254f * v;
      const float s_low = -sgnf(cosa + 1e-12f);
      const Frame f = plane_frame(R1);
      const float caps[4] = {1.f, -1.f, s_low, s_low};
      const V3 dirs[4] = {u, u, u120, u240};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const V3 pt = x2 + (caps[j] * h) * axis + r * dirs[j];
        const float dist = dot(n, pt - x1);
        slots.put(j, dist, pt - (0.5f * dist) * n, f);
      }
      break;
    }
    case kPlaneBox:
      if constexpr (kBoxes)
        plane_box(slots, x1, env.mat(g1), x2, env.mat(g2), s2);
      break;
    case kSphereSphere:
      spheres(slots, x1, s1.x, x2, s2.x);
      break;
    case kSphereCapsule: {
      const V3 ax = s2.y * col(env.mat(g2), 2);
      spheres(slots, x1, s1.x, segpoint(x1, x2 - ax, x2 + ax), s2.x);
      break;
    }
    case kCapsuleCapsule: {                  // three alternations
      const V3 a_ax = s1.y * col(env.mat(g1), 2);
      const V3 b_ax = s2.y * col(env.mat(g2), 2);
      V3 pa = x1, pb = x2;
#pragma unroll
      for (int it = 0; it < 3; ++it) {
        pb = segpoint(pa, x2 - b_ax, x2 + b_ax);
        pa = segpoint(pb, x1 - a_ax, x1 + a_ax);
      }
      spheres(slots, pa, s1.x, pb, s2.x);
      break;
    }
    case kSphereBox:
      sphere_box(slots, x1, s1.x, x2, env.mat(g2), s2);
      break;
    case kBoxBox:
      if constexpr (kBoxes)
        box_box(slots, x1, env.mat(g1), s1, x2, env.mat(g2), s2);
      break;
  }
}

static const void* kernel_of(int boxes) {
  return boxes ? (const void*)collision_kernel<true>
               : (const void*)collision_kernel<false>;
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM, of the instantiation ``boxes``.
extern "C" int collision_resources(ColModel m, int boxes, int* out4) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel_of(boxes));
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_of(boxes), kThreads, 0);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)a.sharedSizeBytes;
  out4[3] = blocks;
  return (int)err;
}

extern "C" int collision_launch(ColModel m, ColIn in, ColOut out, int batch,
                                int boxes, void* stream) {
  if (m.npair < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)batch * m.npair;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (boxes)
    collision_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        m, in, out, batch);
  else
    collision_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        m, in, out, batch);
  return (int)cudaGetLastError();
}
