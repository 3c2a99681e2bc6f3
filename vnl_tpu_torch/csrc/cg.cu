// Kernel B: the whole CG contact solve of one physics substep, one thread
// block per env.
//
// Replaces the TPU kernel vnl_tpu/ops/pallas_cg.py::_cg_kernel (built by
// make_cg_fused): a fixed number of preconditioned Polak-Ribiere CG
// iterations (beta >= 0), each with an exact piecewise-quadratic line search
// of ls_iters active-set rounds, over pyramidal 4-facet contacts and
// one-sided joint limits.  The contact Jacobian stays factored,
// J = (chain2 * G2 - chain1 * G1) . cdof, and is never built.
//
// What bounds it on an H100: per env it reads qM and qMinv (2 nv^2 floats)
// plus a few KB of constraint data and writes about 1 KB; the arithmetic is
// two nv x nv matvecs and two factored J products per iteration.  Both
// limits are microseconds for a thousand envs; the cost is the chain of
// dependent phases inside one solve, so the design makes each phase short
// and keeps the barriers between them few (8 per iteration).
//
// Design:
//  * Static structure comes as tables built once per model (ops/cg.py):
//    per (side, contact) the list of dofs of its kinematic chain, per dof
//    the list of (side, contact) chains it lies on, and per dof its limit
//    row.  J v walks the first, J^T f the second; no 0/1 mask is read.
//  * qM and qMinv are staged into shared memory by cp.async (16 bytes a
//    copy where source and destination agree modulo 16, which the
//    destination's offset arranges), and the first J x, forces and gradient
//    run while the copies are in flight.
//  * Every loop that walks a list or a row loads a batch of operands
//    before it uses them (unrolled by hand), because a step of such a loop
//    costs a load's latency, not an instruction, when it is left rolled.
//  * A matvec gives a row to a thread, which adds the row's terms in
//    ascending order into one sum (the order of the plain version's and the
//    TPU kernel's products, which keeps the ill-conditioned envs of a batch
//    as close to them as they are to each other).  That uses nv threads, so
//    J p, which is independent of M p, runs on the other warps meanwhile.
//    The dot products of an iteration ride on the matvecs: each warp reduces
//    its rows' terms by shuffles and stores one partial, and every thread
//    adds the warps' partials in warp order after the barrier the matvec
//    needs anyway.
//  * The line search needs no barrier between its rounds: warp 0 holds the
//    nlimit + 4 ncon rows' (J x - aref, J p, D) in registers, LSN rows a
//    lane, reduces the active-set sums with xor shuffles and hands alpha to
//    the block through shared memory; the other warps spend no instruction
//    on it.
//  * Fixed iteration count, no early exit, M(x - a) updated incrementally,
//    as the TPU kernel does.  Every reduction has a fixed order: two runs on
//    the same inputs give the same bits.
// fp32 throughout; the kernel allocates nothing and runs on the caller's
// stream.

#include <cuda_runtime.h>
#include <cstdint>

struct CgModel {
  int nv, ncon, nlimit, iters, ls_iters;
  const int* lim_dof;     // (nlimit) dof of each limit row
  const int* lim_of_dof;  // (nv) limit row of each dof, -1 where none
  const int* side_start;  // (2 ncon + 1) offsets into side_dof; side
                          // s = sd * ncon + c, sd 0: chain2 (+), 1: chain1 (-)
  const int* side_dof;    // dofs of each side's chain, ascending
  const int* dof_start;   // (nv + 1) offsets into dof_side
  const int* dof_side;    // sides whose chain holds the dof
};

struct CgIn {
  const float *qM, *qMinv, *x0, *cdof, *g36, *lim_sign, *lim_aref, *lim_D,
      *con_mu, *con_aref, *con_D;
};

struct CgOut {
  float *qacc, *qfrc, *con_f;
};

constexpr int kThreads = 256;   // threads per block (one block per env)
constexpr int kMaxWarps = kThreads / 32;

// Offsets (in floats) into dynamic shared memory.  Rows of the constraint
// system are kept together, limits first, then 4 facets per contact.
struct Layout {
  int M, Minv, cdof, g, mu, lsign, aref, D, jx, jp, f, x, Mxa, gr, p, Mp, tmp,
      jtf, side, red, total;
};

__host__ __device__ inline Layout make_layout(int nv, int nc, int nl) {
  Layout L;
  const int nmat = ((nv * nv + 3 + 3) / 4) * 4;  // room for the 16-byte shift
  const int R = nl + 4 * nc;
  int o = 0;
  L.M = o;     o += nmat;
  L.Minv = o;  o += nmat;
  L.cdof = o;  o += nv * 6;
  L.g = o;     o += 36 * nc;
  L.mu = o;    o += 2 * nc;
  L.lsign = o; o += nl;
  L.aref = o;  o += R;
  L.D = o;     o += R;
  L.jx = o;    o += R;
  L.jp = o;    o += R;
  L.f = o;     o += R;
  L.x = o;     o += nv;
  L.Mxa = o;   o += nv;
  L.gr = o;    o += nv;
  L.p = o;     o += nv;
  L.Mp = o;    o += nv;
  L.tmp = o;   o += nv;
  L.jtf = o;   o += nv;
  L.side = o;  o += 12 * nc;
  L.red = o;   o += 2 * kMaxWarps + 1;   // warps' partial sums, alpha
  L.total = o;
  return L;
}

struct Smem {
  float *M, *Minv, *cdof, *g, *mu, *lsign, *aref, *D, *jx, *jp, *f;
  float *x, *Mxa, *gr, *p, *Mp, *tmp, *jtf, *side, *red;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Starts the copy of n floats from src into the 16-byte aligned buffer dst16
// and returns where they land: shifted by up to 3 floats so that source and
// destination agree modulo 16 bytes and the body goes 16 bytes a copy.
__device__ float* stage(float* dst16, const float* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int off = (int)(((uintptr_t)src >> 2) & 3);
  float* dst = dst16 + off;
  int head = (4 - off) & 3;
  if (head > n) head = n;
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  for (int i = tid; i < head; i += nt) cp_async4(dst + i, src + i);
  for (int i = tid; i < nvec; i += nt)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = tail + tid; i < n; i += nt) cp_async4(dst + i, src + i);
  return dst;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // the same bits in every lane
}

// First half of J v: limit rows, and per side and spatial component the sum
// of cdof[d] v[d] over the side's chain.  side[(sd * nc + c) * 6 + k].
// Runs on the threads t = 0..n-1 of a group.
__device__ void jv_sides(const CgModel& m, const Smem& s, const float* v,
                         float* ljv, int t0, int n, int skip) {
  const int nc = m.ncon;
  for (int l = t0; l < m.nlimit; l += n)
    ljv[l] = s.lsign[l] * v[m.lim_dof[l]];
  for (int i = t0; i < 12 * nc; i += n) {
    const int sc = i / 6, k = i - sc * 6;
    const int lo = m.side_start[sc];
    const int hi = (skip & 1) ? lo : m.side_start[sc + 1];
    float acc = 0.0f;
    int t = lo;
    for (; t + 4 <= hi; t += 4) {
      int d[4];
      float c[4], x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) d[u] = m.side_dof[t + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = s.cdof[d[u] * 6 + k];
        x[u] = v[d[u]];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += c[u] * x[u];
    }
    for (; t < hi; ++t) {
      const int d = m.side_dof[t];
      acc += s.cdof[d * 6 + k] * v[d];
    }
    s.side[i] = acc;
  }
}

// Second half of J v: the 4 facet rows of each contact, one lane per row;
// the lanes of a contact share its three frame components by shuffles.
__device__ void jv_rows(const CgModel& m, const Smem& s, float* cjv) {
  const int nc = m.ncon, nt = blockDim.x;
  const int lane = threadIdx.x & 31, t00 = threadIdx.x - lane;
  for (int t0 = t00; t0 < 4 * nc; t0 += nt) {
    const int t = t0 + lane, c = t >> 2, f = t & 3;
    const bool ok = c < nc;
    float base = 0.0f;
    if (ok && f < 3) {
      for (int k = 0; k < 6; ++k)
        base += s.g[(f * 6 + k) * nc + c] * s.side[c * 6 + k] -
                s.g[(18 + f * 6 + k) * nc + c] * s.side[(nc + c) * 6 + k];
    }
    const int q0 = lane & ~3;
    const float b0 = __shfl_sync(0xffffffffu, base, q0);
    const float b1 = __shfl_sync(0xffffffffu, base, q0 + 1);
    const float b2 = __shfl_sync(0xffffffffu, base, q0 + 2);
    if (ok) {
      const float mu = s.mu[c * 2 + (f >> 1)];
      const float bb = (f < 2) ? b1 : b2;
      cjv[t] = (f & 1) ? b0 - mu * bb : b0 + mu * bb;
    }
  }
}

__device__ __forceinline__ float force(float jx, float aref, float D) {
  const float jar = jx - aref;
  return jar < 0.0f ? -D * jar : 0.0f;
}

// First half of J^T f: per side and spatial component, G f of its contact.
__device__ void jtf_sides(const CgModel& m, const Smem& s) {
  const int nc = m.ncon, tid = threadIdx.x, nt = blockDim.x;
  const float* cf = s.f + m.nlimit;
  for (int i = tid; i < 12 * nc; i += nt) {
    const int sc = i / 6, k = i - sc * 6;
    const int sd = sc >= nc, c = sc - sd * nc;
    const float* f4 = &cf[c * 4];
    const float fv[3] = {f4[0] + f4[1] + f4[2] + f4[3],
                         s.mu[c * 2] * (f4[0] - f4[1]),
                         s.mu[c * 2 + 1] * (f4[2] - f4[3])};
    float acc = 0.0f;
    for (int f = 0; f < 3; ++f)
      acc += s.g[(sd * 18 + f * 6 + k) * nc + c] * fv[f];
    s.side[i] = acc;
  }
}

// Second half: jtf = J^T f per dof, and out = Mxa - jtf (the gradient).
__device__ void grad(const CgModel& m, const Smem& s, float* out, int skip) {
  const int nc = m.ncon, tid = threadIdx.x, nt = blockDim.x;
  for (int d = tid; d < m.nv; d += nt) {
    float u[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int lo = m.dof_start[d];
    const int hi = (skip & 2) ? lo : m.dof_start[d + 1];
    int t = lo;
    for (; t + 2 <= hi; t += 2) {   // two chains' loads before their sums
      const int sa = m.dof_side[t], sb = m.dof_side[t + 1];
      float va[6], vb[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        va[k] = s.side[sa * 6 + k];
        vb[k] = s.side[sb * 6 + k];
      }
      const float ga = sa < nc ? 1.0f : -1.0f, gb = sb < nc ? 1.0f : -1.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) u[k] = (u[k] + ga * va[k]) + gb * vb[k];
    }
    for (; t < hi; ++t) {
      const int sc = m.dof_side[t];
      const float g = sc < nc ? 1.0f : -1.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) u[k] += g * s.side[sc * 6 + k];
    }
    float jtf = 0.0f;
    const int l = m.lim_of_dof[d];
    if (l >= 0) jtf += s.lsign[l] * s.f[l];
    for (int k = 0; k < 6; ++k) jtf += s.cdof[d * 6 + k] * u[k];
    s.jtf[d] = jtf;
    out[d] = s.Mxa[d] - jtf;
  }
}

// out = M v on the first ceil(nv / 32) warps, a row a thread, the row's terms
// added in ascending order; 8 of them are loaded before they are used.
// Each of these warps also leaves in red[2 warp], [+1] the sums over its rows
// of ua[i] wa[i] and ub[i] out[i] (wa == nullptr: of ua[i] out[i] and
// ub[i] out[i]).
__device__ void matvec_dots(int nv, const float* M, const float* v, float* out,
                            const float* ua, const float* wa, const float* ub,
                            float* red, int skip) {
  const int i = threadIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sa = 0.0f, sb = 0.0f;
  if (i < nv) {
    const float* row = M + i * nv;
    float acc = 0.0f;
    int j = 0;
    const int n = (skip & 4) ? 0 : nv;
    for (; j + 8 <= n; j += 8) {
      float a[8], x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        a[u] = row[j + u];
        x[u] = v[j + u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += a[u] * x[u];
    }
    for (; j < n; ++j) acc += row[j] * v[j];
    out[i] = acc;
    sa = ua[i] * (wa ? wa[i] : acc);
    sb = ub[i] * acc;
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    red[2 * warp] = sa;
    red[2 * warp + 1] = sb;
  }
}

// The two block totals left by matvec_dots, added in warp order.
__device__ __forceinline__ void read_dots(const float* red, int nw, float* a,
                                          float* b) {
  float sa = 0.0f, sb = 0.0f;
  for (int w = 0; w < nw; ++w) {
    sa += red[2 * w];
    sb += red[2 * w + 1];
  }
  *a = sa;
  *b = sb;
}

// LSN: rows of the constraint system a lane holds in registers in the line
// search, 32 * LSN >= nlimit + 4 ncon; LSN = 0 reads them from shared memory
// in every round and takes any number of rows.  skip (profiling only, the outputs are then
// wrong): bit 0 empties the chain lists of J v, bit 1 those of J^T f, bit 2
// leaves out the matvecs' inner loops.
template <int LSN>
__global__ void __launch_bounds__(kThreads, 4)
cg_kernel(CgModel m, CgIn in, CgOut out, int skip) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nv = m.nv, nc = m.ncon, nl = m.nlimit, R = nl + 4 * nc;
  const int e = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the first mvw warps hold a row of the matvecs each thread
  const int mvw = (nv + 31) >> 5, mvt = mvw * 32;

  const Layout L = make_layout(nv, nc, nl);
  Smem s;
  s.cdof = sm + L.cdof; s.g = sm + L.g; s.mu = sm + L.mu;
  s.lsign = sm + L.lsign; s.aref = sm + L.aref; s.D = sm + L.D;
  s.jx = sm + L.jx; s.jp = sm + L.jp; s.f = sm + L.f; s.x = sm + L.x;
  s.Mxa = sm + L.Mxa; s.gr = sm + L.gr; s.p = sm + L.p; s.Mp = sm + L.Mp;
  s.tmp = sm + L.tmp; s.jtf = sm + L.jtf; s.side = sm + L.side;
  s.red = sm + L.red;

  // the two matrices start moving; nothing reads them before the wait
  const size_t mo = (size_t)e * nv * nv;
  s.M = stage(sm + L.M, in.qM + mo, nv * nv);
  s.Minv = stage(sm + L.Minv, in.qMinv + mo, nv * nv);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = tid; i < nv * 6; i += nt)
    s.cdof[i] = in.cdof[(size_t)e * nv * 6 + i];
  for (int i = tid; i < 36 * nc; i += nt)
    s.g[i] = in.g36[(size_t)e * 36 * nc + i];
  for (int i = tid; i < 2 * nc; i += nt)
    s.mu[i] = in.con_mu[(size_t)e * 2 * nc + i];
  for (int i = tid; i < 4 * nc; i += nt) {
    s.aref[nl + i] = in.con_aref[(size_t)e * 4 * nc + i];
    s.D[nl + i] = in.con_D[(size_t)e * 4 * nc + i];
  }
  for (int i = tid; i < nl; i += nt) {
    s.lsign[i] = in.lim_sign[(size_t)e * nl + i];
    s.aref[i] = in.lim_aref[(size_t)e * nl + i];
    s.D[i] = in.lim_D[(size_t)e * nl + i];
  }
  for (int i = tid; i < nv; i += nt) {
    s.x[i] = in.x0[(size_t)e * nv + i];
    s.Mxa[i] = 0.0f;  // x starts at qacc_smooth, so M(x - a) starts at 0
  }
  __syncthreads();

  // gradient at x0
  jv_sides(m, s, s.x, s.jx, tid, nt, skip);
  __syncthreads();
  jv_rows(m, s, s.jx + nl);
  __syncthreads();
  for (int r = tid; r < R; r += nt) s.f[r] = force(s.jx[r], s.aref[r], s.D[r]);
  __syncthreads();
  jtf_sides(m, s);
  __syncthreads();
  grad(m, s, s.gr, skip);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (warp < mvw)
    matvec_dots(nv, s.Minv, s.gr, s.Mp, s.gr, nullptr, s.gr, s.red, skip);
  __syncthreads();
  float gMg, unused;
  read_dots(s.red, mvw, &gMg, &unused);
  for (int i = tid; i < nv; i += nt) s.p[i] = -s.Mp[i];
  __syncthreads();

  for (int it = 0; it < m.iters; ++it) {
    // Mp = M p with the partial sums of p . Mxa and p . Mp on the first
    // warps, the first half of J p on the others
    if (warp < mvw)
      matvec_dots(nv, s.M, s.p, s.Mp, s.p, s.Mxa, s.p, s.red, skip);
    else
      jv_sides(m, s, s.p, s.jp, tid - mvt, nt - mvt, skip);
    __syncthreads();
    jv_rows(m, s, s.jp + nl);
    __syncthreads();

    // exact line search on the piecewise quadratic along p, on warp 0
    if (warp == 0) {
      float num0, den0;
      read_dots(s.red, mvw, &num0, &den0);
      float al = 0.0f;
      if (LSN > 0) {   // the rows stay in registers over the rounds
        float jar[LSN > 0 ? LSN : 1], jp[LSN > 0 ? LSN : 1],
            Dj[LSN > 0 ? LSN : 1];
#pragma unroll
        for (int q = 0; q < LSN; ++q) {
          const int r = lane + 32 * q;
          const bool ok = r < R;
          jar[q] = ok ? s.jx[r] - s.aref[r] : 0.0f;
          jp[q] = ok ? s.jp[r] : 0.0f;
          Dj[q] = ok ? s.D[r] * jp[q] : 0.0f;
        }
        for (int ls = 0; ls < m.ls_iters; ++ls) {
          float a = 0.0f, b = 0.0f;
#pragma unroll
          for (int q = 0; q < LSN; ++q) {
            if (jar[q] + al * jp[q] < 0.0f) {
              a += Dj[q] * jar[q];
              b += Dj[q] * jp[q];
            }
          }
          a = warp_sum(a);
          b = warp_sum(b);
          al = -(num0 + a) / fmaxf(den0 + b, 1e-12f);
        }
      } else {         // any number of rows, read again in every round
        for (int ls = 0; ls < m.ls_iters; ++ls) {
          float a = 0.0f, b = 0.0f;
          for (int r = lane; r < R; r += 32) {
            const float jar = s.jx[r] - s.aref[r], jp = s.jp[r];
            if (jar + al * jp < 0.0f) {
              const float Dj = s.D[r] * jp;
              a += Dj * jar;
              b += Dj * jp;
            }
          }
          a = warp_sum(a);
          b = warp_sum(b);
          al = -(num0 + a) / fmaxf(den0 + b, 1e-12f);
        }
      }
      if (lane == 0) s.red[2 * kMaxWarps] = al;
    }
    __syncthreads();
    const float alpha = s.red[2 * kMaxWarps];

    for (int i = tid; i < nv; i += nt) {
      s.x[i] += alpha * s.p[i];
      s.Mxa[i] += alpha * s.Mp[i];
    }
    for (int r = tid; r < R; r += nt) {
      const float jx = s.jx[r] + alpha * s.jp[r];
      s.jx[r] = jx;
      s.f[r] = force(jx, s.aref[r], s.D[r]);
    }
    __syncthreads();
    jtf_sides(m, s);
    __syncthreads();
    grad(m, s, s.tmp, skip);  // g_new
    __syncthreads();
    // Mg_new into Mp (spent by now); sums of g_new . Mg_new and g . Mg_new
    if (warp < mvw)
      matvec_dots(nv, s.Minv, s.tmp, s.Mp, s.tmp, nullptr, s.gr, s.red, skip);
    __syncthreads();
    float gnMgn, gMgn;
    read_dots(s.red, mvw, &gnMgn, &gMgn);
    const float beta = fmaxf(0.0f, (gnMgn - gMgn) / fmaxf(gMg, 1e-12f));
    for (int i = tid; i < nv; i += nt) {
      s.p[i] = -s.Mp[i] + beta * s.p[i];
      s.gr[i] = s.tmp[i];
    }
    gMg = gnMgn;
    __syncthreads();
  }

  // f and jtf are those of the final x
  for (int i = tid; i < nv; i += nt) {
    out.qacc[(size_t)e * nv + i] = s.x[i];
    out.qfrc[(size_t)e * nv + i] = s.jtf[i];
  }
  for (int r = tid; r < 4 * nc; r += nt)
    out.con_f[(size_t)e * 4 * nc + r] = s.f[nl + r];
}

typedef void (*CgKernel)(CgModel, CgIn, CgOut, int);

// The line search keeps up to 5 rows a lane in registers (160 rows; the
// rodent has 159); wider systems read them from shared memory.
static CgKernel pick_kernel(const CgModel& m) {
  return m.nlimit + 4 * m.ncon <= 32 * 5 ? cg_kernel<5> : cg_kernel<0>;
}

static size_t smem_bytes(const CgModel& m) {
  return (size_t)make_layout(m.nv, m.ncon, m.nlimit).total * sizeof(float);
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int cg_resources(CgModel m, int* out4) {
  CgKernel fn = pick_kernel(m);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(m);
  err = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)fn, kThreads, smem);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)(smem + a.sharedSizeBytes);
  out4[3] = blocks;
  return (int)err;
}

extern "C" int cg_launch(CgModel m, CgIn in, CgOut out, int batch,
                         void* stream, int skip) {
  // the matvecs need a thread per dof and leave a warp for J p
  if (kThreads < 32 * ((m.nv + 31) / 32 + 1)) return (int)cudaErrorInvalidValue;
  CgKernel fn = pick_kernel(m);
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<batch, kThreads, smem, (cudaStream_t)stream>>>(m, in, out, skip);
  return (int)cudaGetLastError();
}
