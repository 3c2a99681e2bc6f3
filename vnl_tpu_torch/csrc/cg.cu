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
//  * Two routes, by the number of constraint rows: up to 160 (the twin's
//    159) the one described here; wider systems (the humanoid's 729) take
//    cg_wide_kernel, whose design is set out above it.  Systems wider
//    than the wide route (the CMU humanoid's 3,984 rows) take this one's
//    widest instantiation, cg_kernel<0>, which reads its rows from shared
//    memory in every round of the line search and leaves g (36 floats a
//    contact) in global memory, read through the read-only path: with g
//    in shared memory the CMU humanoid's system would need 310 KB of the
//    227 KB a block may have, without it 169 KB.
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

// The wide route's model (ops/cg.py kernel_tables): CgModel's fields in
// its order, the group and chunk counts after its sizes, then the
// per-body tables.  A struct of its own, so that the twin's route keeps
// the parameters it was tuned with.  The wide route reads only the sizes
// and limit tables of CgModel's part, but without the per-side tables
// ptxas gave its humanoid instantiation 192 bytes of spills instead of 24
// and the solve took 0.205 ms instead of 0.175 on an H100 at 1024 envs
// (PERF.md section 6).
struct CgWide {
  int nv, ncon, nlimit, iters, ls_iters;
  int ngrp, nchunk;       // groups (bodies with contacts) and chunks
  const int* lim_dof;     // (nlimit) dof of each limit row
  const int* lim_of_dof;  // (nv) limit row of each dof, -1 where none
  const int* side_start;  // CgModel's per-side tables
  const int* side_dof;
  const int* dof_start;
  const int* dof_side;
  const int* grp_start;   // (ngrp + 1) offsets into grp_dof
  const int* grp_dof;     // dofs of each group's chain, ascending
  const int* grp_of_side; // (2 ncon) group of each side, ngrp if empty
  const int* chunk_start; // (nchunk + 1) offsets into chunk_side
  const int* chunk_side;  // each group's sides, ascending, in chunks
  const int* dof_cstart;  // (nv + 1) offsets into dof_chunk
  const int* dof_chunk;   // chunks whose chain holds the dof, ascending
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
// system are kept together, limits first, then 4 facets per contact.  g
// has no room where it stays in global memory (g_shared false: the
// widest route).
struct Layout {
  int M, Minv, cdof, g, mu, lsign, aref, D, jx, jp, f, x, Mxa, gr, p, Mp, tmp,
      jtf, side, red, total;
};

__host__ __device__ inline Layout make_layout(int nv, int nc, int nl,
                                              bool g_shared) {
  Layout L;
  const int nmat = ((nv * nv + 3 + 3) / 4) * 4;  // room for the 16-byte shift
  const int R = nl + 4 * nc;
  int o = 0;
  L.M = o;     o += nmat;
  L.Minv = o;  o += nmat;
  L.cdof = o;  o += nv * 6;
  L.g = o;     o += g_shared ? 36 * nc : 0;
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
  float *M, *Minv, *cdof;
  const float* g;
  float *mu, *lsign, *aref, *D, *jx, *jp, *f;
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

// g's entry i: from shared memory, or (kGlobalG, the widest route) from
// global memory through the read-only path
template <bool kGlobalG>
__device__ __forceinline__ float g_at(const float* g, int i) {
  if constexpr (kGlobalG)
    return __ldg(g + i);
  else
    return g[i];
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
template <bool kGlobalG>
__device__ void jv_rows(const CgModel& m, const Smem& s, float* cjv) {
  const int nc = m.ncon, nt = blockDim.x;
  const int lane = threadIdx.x & 31, t00 = threadIdx.x - lane;
  for (int t0 = t00; t0 < 4 * nc; t0 += nt) {
    const int t = t0 + lane, c = t >> 2, f = t & 3;
    const bool ok = c < nc;
    float base = 0.0f;
    if (ok && f < 3) {
      for (int k = 0; k < 6; ++k)
        base += g_at<kGlobalG>(s.g, (f * 6 + k) * nc + c) *
                    s.side[c * 6 + k] -
                g_at<kGlobalG>(s.g, (18 + f * 6 + k) * nc + c) *
                    s.side[(nc + c) * 6 + k];
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
template <bool kGlobalG>
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
      acc += g_at<kGlobalG>(s.g, (sd * 18 + f * 6 + k) * nc + c) * fv[f];
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

  constexpr bool kGlobalG = LSN == 0;   // g stays in global memory
  const Layout L = make_layout(nv, nc, nl, !kGlobalG);
  Smem s;
  s.cdof = sm + L.cdof; s.mu = sm + L.mu;
  s.g = kGlobalG ? in.g36 + (size_t)e * 36 * nc : sm + L.g;
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
  if constexpr (!kGlobalG)
    for (int i = tid; i < 36 * nc; i += nt)
      sm[L.g + i] = in.g36[(size_t)e * 36 * nc + i];
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
  jv_rows<kGlobalG>(m, s, s.jx + nl);
  __syncthreads();
  for (int r = tid; r < R; r += nt) s.f[r] = force(s.jx[r], s.aref[r], s.D[r]);
  __syncthreads();
  jtf_sides<kGlobalG>(m, s);
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
    jv_rows<kGlobalG>(m, s, s.jp + nl);
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
    jtf_sides<kGlobalG>(m, s);
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

// ---------------------------------------------------------------------------
// The route for wide systems (more than 160 rows; the humanoid has 729).
// The twin's route above walks, per dof, every side whose chain holds the
// dof: on the humanoid the six root dofs hold all 319 sides, so J^T f was
// a serial walk of 319 steps on 27 threads while 229 waited; its line
// search read 729 rows from shared memory on one warp.  Here:
//  * J^T f as sums over the body tree.  A side's chain is that of one
//    body, and the sides whose chain holds dof d are those whose body lies
//    below d's body.  The sides are grouped by body and each group's list
//    cut into chunks (ops/cg.py body_tables); one thread a (chunk,
//    component) adds its sides' G f, then eight lanes a dof add, per
//    component, the chunks of the bodies below the dof's body
//    (dof_chunk), multiply by cdof and reduce by three shuffles.  The
//    humanoid's longest walks are 9 sides and 37 chunks.
//  * J v once a body: one walk a (group, component), read by each side of
//    the group.  A group's dofs are its sides' dofs in the same order, so
//    J v keeps the bits of the per-side walks.
//  * Rows in registers.  Contact row t = 4 c + f lives in slot t / 256 of
//    thread t % 256 (the four rows of a contact in four neighbouring
//    lanes), limit row l in slot l / 256 of thread l % 256; the owner
//    keeps J x, aref, D (read from global memory once) and computes J p,
//    the forces and each contact's three force components (shuffles) in
//    place.  The line search runs on all warps: per round a warp sum, one
//    barrier, and every thread adds the eight warps' partials in warp
//    order, so every thread holds the same alpha and two launches agree.
//  * g36 and mu are staged by cp.async behind the first J x walk, qM and
//    qMinv behind the first gradient.
// ---------------------------------------------------------------------------

// Offsets (in floats) into dynamic shared memory of the wide route; every
// buffer starts on 16 bytes.
struct WLayout {
  int M, Minv, cdof, g, mu, x, Mxa, gr, p, Mp, tmp, jtf, grp, fv, lf, part,
      gos, red, total;
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline WLayout make_wlayout(const CgWide& m) {
  const int nv = m.nv, nc = m.ncon;
  WLayout L;
  int o = 0;
  L.M = o;     o += up4(nv * nv + 3);   // + room for the 16-byte shift
  L.Minv = o;  o += up4(nv * nv + 3);
  L.cdof = o;  o += up4(nv * 6);
  L.g = o;     o += up4(36 * nc + 3);
  L.mu = o;    o += up4(2 * nc + 3);
  L.x = o;     o += up4(nv);
  L.Mxa = o;   o += up4(nv);
  L.gr = o;    o += up4(nv);
  L.p = o;     o += up4(nv);
  L.Mp = o;    o += up4(nv);
  L.tmp = o;   o += up4(nv);
  L.jtf = o;   o += up4(nv);
  L.grp = o;   o += up4((m.ngrp + 1) * 6);   // J v per group; a zero group
  L.fv = o;    o += up4(3 * nc);             // G's three force components
  L.lf = o;    o += up4(m.nlimit);           // lsign f of the limit rows
  L.part = o;  o += up4(m.nchunk * 6);       // J^T f per chunk
  L.gos = o;   o += up4(2 * nc);             // (int) grp_of_side
  L.red = o;   o += 2 * kMaxWarps + 4 * kMaxWarps;  // matvecs', line search's
  L.total = o;
  return L;
}

// First half of J v: per group and spatial component, the sum of cdof[d]
// v[d] over the group's chain, in ascending order (as jv_sides).
__device__ void jv_groups(const CgWide& m, const float* cdof, const float* v,
                          float* grp, int t0, int n, int skip) {
  for (int i = t0; i < 6 * m.ngrp; i += n) {
    const int gi = i / 6, k = i - gi * 6;
    const int lo = m.grp_start[gi];
    const int hi = (skip & 1) ? lo : m.grp_start[gi + 1];
    float acc = 0.0f;
    int t = lo;
    for (; t + 4 <= hi; t += 4) {
      int d[4];
      float c[4], x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) d[u] = m.grp_dof[t + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = cdof[d[u] * 6 + k];
        x[u] = v[d[u]];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += c[u] * x[u];
    }
    for (; t < hi; ++t) {
      const int d = m.grp_dof[t];
      acc += cdof[d * 6 + k] * v[d];
    }
    grp[i] = acc;
  }
}

// Second half of J v for the contact rows a thread owns (as jv_rows): the
// three lanes f < 3 of a contact form G (chain2 - chain1) J of the
// contact's frame row f, all four lanes of it take the facets.
template <int NCS>
__device__ __forceinline__ void jv_owned(int nc, const float* g,
                                         const float* mu, const float* grp,
                                         const int* gos, float (&out)[NCS]) {
  const int lane = threadIdx.x & 31, q0 = lane & ~3;
#pragma unroll
  for (int q = 0; q < NCS; ++q) {
    const int t = threadIdx.x + kThreads * q, c = t >> 2, f = t & 3;
    const bool ok = c < nc;
    float base = 0.0f;
    if (ok && f < 3) {
      const float* s2 = grp + gos[c] * 6;
      const float* s1 = grp + gos[nc + c] * 6;
      for (int k = 0; k < 6; ++k)
        base += g[(f * 6 + k) * nc + c] * s2[k] -
                g[(18 + f * 6 + k) * nc + c] * s1[k];
    }
    const float b0 = __shfl_sync(0xffffffffu, base, q0);
    const float b1 = __shfl_sync(0xffffffffu, base, q0 + 1);
    const float b2 = __shfl_sync(0xffffffffu, base, q0 + 2);
    float jv = 0.0f;
    if (ok) {
      const float m1 = mu[c * 2 + (f >> 1)];
      const float bb = (f < 2) ? b1 : b2;
      jv = (f & 1) ? b0 - m1 * bb : b0 + m1 * bb;
    }
    out[q] = jv;
  }
}

// The forces of the rows a thread owns at J x = jx: each contact's three
// force components into fv (its lanes f < 3), lsign f of the limit rows
// into lf.
template <int NCS, int NLS>
__device__ __forceinline__ void publish_forces(
    int nc, int nl, const float* mu, const float (&jx)[NCS],
    const float (&aref)[NCS], const float (&D)[NCS], const float (&ljx)[NLS],
    const float (&laref)[NLS], const float (&lD)[NLS],
    const float (&lsign)[NLS], float* fv, float* lf) {
  const int lane = threadIdx.x & 31, q0 = lane & ~3;
#pragma unroll
  for (int q = 0; q < NCS; ++q) {
    const int t = threadIdx.x + kThreads * q, c = t >> 2, f = t & 3;
    const bool ok = c < nc;
    const float fr = ok ? force(jx[q], aref[q], D[q]) : 0.0f;
    const float f0 = __shfl_sync(0xffffffffu, fr, q0);
    const float f1 = __shfl_sync(0xffffffffu, fr, q0 + 1);
    const float f2 = __shfl_sync(0xffffffffu, fr, q0 + 2);
    const float f3 = __shfl_sync(0xffffffffu, fr, q0 + 3);
    if (ok && f < 3)
      fv[c * 3 + f] = f == 0 ? f0 + f1 + f2 + f3
                    : f == 1 ? mu[c * 2] * (f0 - f1)
                             : mu[c * 2 + 1] * (f2 - f3);
  }
#pragma unroll
  for (int q = 0; q < NLS; ++q) {
    const int l = threadIdx.x + kThreads * q;
    if (l < nl) lf[l] = lsign[q] * force(ljx[q], laref[q], lD[q]);
  }
}

// J^T f, first level: per (chunk, component) the sum over the chunk's
// sides of +-(G f) of the side, G f = sum_f g[sd, f, k, c] fv[c, f].
__device__ void jtf_chunks(const CgWide& m, const float* g, const float* fv,
                           float* part, int skip) {
  const int nc = m.ncon;
  for (int i = threadIdx.x; i < 6 * m.nchunk; i += kThreads) {
    const int ch = i / 6, k = i - ch * 6;
    const int lo = m.chunk_start[ch];
    const int hi = (skip & 2) ? lo : m.chunk_start[ch + 1];
    float acc = 0.0f;
    int t = lo;
    for (; t + 2 <= hi; t += 2) {   // two sides' loads before their sums
      float gf[2];
      bool neg[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int sc = m.chunk_side[t + u];
        neg[u] = sc >= nc;
        const int c = neg[u] ? sc - nc : sc;
        const float* gs = g + (neg[u] ? 18 : 0) * nc + k * nc + c;
        gf[u] = gs[0] * fv[c * 3] + gs[6 * nc] * fv[c * 3 + 1] +
                gs[12 * nc] * fv[c * 3 + 2];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) acc += neg[u] ? -gf[u] : gf[u];
    }
    for (; t < hi; ++t) {
      const int sc = m.chunk_side[t];
      const bool neg = sc >= nc;
      const int c = neg ? sc - nc : sc;
      const float* gs = g + (neg ? 18 : 0) * nc + k * nc + c;
      const float gf = gs[0] * fv[c * 3] + gs[6 * nc] * fv[c * 3 + 1] +
                       gs[12 * nc] * fv[c * 3 + 2];
      acc += neg ? -gf : gf;
    }
    part[i] = acc;
  }
}

// J^T f, second level, and the gradient out = Mxa - J^T f: eight lanes a
// dof, lane k < 6 adds component k of the chunks below the dof's body and
// multiplies by cdof[d, k]; three shuffles add the lanes.
__device__ void grad_tree(const CgWide& m, const float* cdof,
                          const float* part, const float* lf, const float* Mxa,
                          float* jtf, float* out, int skip) {
  const int k = threadIdx.x & 7, lane = threadIdx.x & 31;
  const unsigned mask = 0xffu << (lane & ~7);
  for (int d0 = 0; d0 < m.nv; d0 += kThreads / 8) {
    const int d = d0 + (threadIdx.x >> 3);
    if (d >= m.nv) continue;     // the eight lanes of a dof agree
    float u = 0.0f;
    if (k < 6) {
      const int lo = m.dof_cstart[d];
      const int hi = (skip & 2) ? lo : m.dof_cstart[d + 1];
      int t = lo;
      for (; t + 4 <= hi; t += 4) {
        int ch[4];
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ch[i] = m.dof_chunk[t + i];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = part[ch[i] * 6 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) u += v[i];
      }
      for (; t < hi; ++t) u += part[m.dof_chunk[t] * 6 + k];
      u *= cdof[d * 6 + k];
    }
    u += __shfl_xor_sync(mask, u, 4, 8);
    u += __shfl_xor_sync(mask, u, 2, 8);
    u += __shfl_xor_sync(mask, u, 1, 8);
    if (k == 0) {
      const int l = m.lim_of_dof[d];
      const float j = l >= 0 ? u + lf[l] : u;
      jtf[d] = j;
      out[d] = Mxa[d] - j;
    }
  }
}

// NCS, NLS: slots of contact rows and of limit rows a thread holds, so
// 4 ncon <= 256 NCS and nlimit <= 256 NLS.  skip as for cg_kernel.
template <int NCS, int NLS>
__global__ void __launch_bounds__(kThreads, 4)
cg_wide_kernel(CgWide m, CgIn in, CgOut out, int skip) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nv = m.nv, nc = m.ncon, nl = m.nlimit;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int mvw = (nv + 31) >> 5, mvt = mvw * 32;

  const WLayout L = make_wlayout(m);
  float* cdof = sm + L.cdof;
  float *x = sm + L.x, *Mxa = sm + L.Mxa, *gr = sm + L.gr, *p = sm + L.p;
  float *Mp = sm + L.Mp, *tmp = sm + L.tmp, *jtf = sm + L.jtf;
  float *grp = sm + L.grp, *fv = sm + L.fv, *lf = sm + L.lf;
  float *part = sm + L.part, *red = sm + L.red;
  float* lsred = red + 2 * kMaxWarps;   // two buffers of 2 kMaxWarps
  int* gos = reinterpret_cast<int*>(sm + L.gos);

  // the contact data, then the matrices, start moving
  const float* g = stage(sm + L.g, in.g36 + (size_t)e * 36 * nc, 36 * nc);
  const float* mu = stage(sm + L.mu, in.con_mu + (size_t)e * 2 * nc, 2 * nc);
  asm volatile("cp.async.commit_group;\n" ::);
  const size_t mo = (size_t)e * nv * nv;
  const float* M = stage(sm + L.M, in.qM + mo, nv * nv);
  const float* Minv = stage(sm + L.Minv, in.qMinv + mo, nv * nv);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = tid; i < nv * 6; i += kThreads)
    cdof[i] = in.cdof[(size_t)e * nv * 6 + i];
  for (int i = tid; i < nv; i += kThreads) {
    x[i] = in.x0[(size_t)e * nv + i];
    Mxa[i] = 0.0f;  // x starts at qacc_smooth, so M(x - a) starts at 0
  }
  for (int i = tid; i < 2 * nc; i += kThreads) gos[i] = m.grp_of_side[i];
  for (int i = tid; i < 6; i += kThreads) grp[6 * m.ngrp + i] = 0.0f;
  // the rows this thread owns: aref and D stay in registers
  float jx[NCS], aref[NCS], D[NCS];
  float ljx[NLS], laref[NLS], lD[NLS], lsign[NLS];
  int ldof[NLS];
#pragma unroll
  for (int q = 0; q < NCS; ++q) {
    const int t = tid + kThreads * q;
    const bool ok = t < 4 * nc;
    aref[q] = ok ? in.con_aref[(size_t)e * 4 * nc + t] : 0.0f;
    D[q] = ok ? in.con_D[(size_t)e * 4 * nc + t] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < NLS; ++q) {
    const int l = tid + kThreads * q;
    const bool ok = l < nl;
    laref[q] = ok ? in.lim_aref[(size_t)e * nl + l] : 0.0f;
    lD[q] = ok ? in.lim_D[(size_t)e * nl + l] : 0.0f;
    lsign[q] = ok ? in.lim_sign[(size_t)e * nl + l] : 0.0f;
    ldof[q] = ok ? m.lim_dof[l] : 0;
  }
  __syncthreads();

  // gradient at x0
  jv_groups(m, cdof, x, grp, tid, kThreads, skip);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  jv_owned<NCS>(nc, g, mu, grp, gos, jx);
#pragma unroll
  for (int q = 0; q < NLS; ++q) ljx[q] = lsign[q] * x[ldof[q]];
  publish_forces<NCS, NLS>(nc, nl, mu, jx, aref, D, ljx, laref, lD, lsign, fv,
                           lf);
  __syncthreads();
  jtf_chunks(m, g, fv, part, skip);
  __syncthreads();
  grad_tree(m, cdof, part, lf, Mxa, jtf, gr, skip);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (warp < mvw)
    matvec_dots(nv, Minv, gr, Mp, gr, nullptr, gr, red, skip);
  __syncthreads();
  float gMg, unused;
  read_dots(red, mvw, &gMg, &unused);
  for (int i = tid; i < nv; i += kThreads) p[i] = -Mp[i];
  __syncthreads();

  for (int it = 0; it < m.iters; ++it) {
    // Mp = M p with the partial sums of p . Mxa and p . Mp on the first
    // warps, the per-body half of J p on the others
    if (warp < mvw)
      matvec_dots(nv, M, p, Mp, p, Mxa, p, red, skip);
    else
      jv_groups(m, cdof, p, grp, tid - mvt, kThreads - mvt, skip);
    __syncthreads();
    float jp[NCS], ljp[NLS];
    jv_owned<NCS>(nc, g, mu, grp, gos, jp);
#pragma unroll
    for (int q = 0; q < NLS; ++q) ljp[q] = lsign[q] * p[ldof[q]];

    // exact line search on the piecewise quadratic along p, on all warps
    float num0, den0;
    read_dots(red, mvw, &num0, &den0);
    float jar[NCS], Dj[NCS], ljar[NLS], lDj[NLS];
#pragma unroll
    for (int q = 0; q < NCS; ++q) {
      jar[q] = jx[q] - aref[q];
      Dj[q] = D[q] * jp[q];
    }
#pragma unroll
    for (int q = 0; q < NLS; ++q) {
      ljar[q] = ljx[q] - laref[q];
      lDj[q] = lD[q] * ljp[q];
    }
    float al = 0.0f;
    for (int ls = 0; ls < m.ls_iters; ++ls) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int q = 0; q < NCS; ++q) {
        if (jar[q] + al * jp[q] < 0.0f) {
          a += Dj[q] * jar[q];
          b += Dj[q] * jp[q];
        }
      }
#pragma unroll
      for (int q = 0; q < NLS; ++q) {
        if (ljar[q] + al * ljp[q] < 0.0f) {
          a += lDj[q] * ljar[q];
          b += lDj[q] * ljp[q];
        }
      }
      a = warp_sum(a);
      b = warp_sum(b);
      float* buf = lsred + (ls & 1) * 2 * kMaxWarps;
      if (lane == 0) {
        buf[2 * warp] = a;
        buf[2 * warp + 1] = b;
      }
      __syncthreads();
      read_dots(buf, kMaxWarps, &a, &b);
      al = -(num0 + a) / fmaxf(den0 + b, 1e-12f);
    }
    const float alpha = al;

    for (int i = tid; i < nv; i += kThreads) {
      x[i] += alpha * p[i];
      Mxa[i] += alpha * Mp[i];
    }
#pragma unroll
    for (int q = 0; q < NCS; ++q) jx[q] += alpha * jp[q];
#pragma unroll
    for (int q = 0; q < NLS; ++q) ljx[q] += alpha * ljp[q];
    publish_forces<NCS, NLS>(nc, nl, mu, jx, aref, D, ljx, laref, lD, lsign,
                             fv, lf);
    __syncthreads();
    jtf_chunks(m, g, fv, part, skip);
    __syncthreads();
    grad_tree(m, cdof, part, lf, Mxa, jtf, tmp, skip);  // g_new
    __syncthreads();
    // Mg_new into Mp (spent by now); sums of g_new . Mg_new and g . Mg_new
    if (warp < mvw)
      matvec_dots(nv, Minv, tmp, Mp, tmp, nullptr, gr, red, skip);
    __syncthreads();
    float gnMgn, gMgn;
    read_dots(red, mvw, &gnMgn, &gMgn);
    const float beta = fmaxf(0.0f, (gnMgn - gMgn) / fmaxf(gMg, 1e-12f));
    for (int i = tid; i < nv; i += kThreads) {
      p[i] = -Mp[i] + beta * p[i];
      gr[i] = tmp[i];
    }
    gMg = gnMgn;
    __syncthreads();
  }

  // f and jtf are those of the final x
  for (int i = tid; i < nv; i += kThreads) {
    out.qacc[(size_t)e * nv + i] = x[i];
    out.qfrc[(size_t)e * nv + i] = jtf[i];
  }
#pragma unroll
  for (int q = 0; q < NCS; ++q) {
    const int t = tid + kThreads * q;
    if (t < 4 * nc)
      out.con_f[(size_t)e * 4 * nc + t] = force(jx[q], aref[q], D[q]);
  }
}

typedef void (*CgKernel)(CgModel, CgIn, CgOut, int);
typedef void (*CgWideKernel)(CgWide, CgIn, CgOut, int);

// The routes, by the number of constraint rows: up to 160 rows (the
// rodent has 159) the line search keeps 5 rows a lane of warp 0 in
// registers; up to 1,024 contact rows and 256 limit rows the wide route;
// wider systems read their rows from shared memory in every round.
// ops/cg.py kernel_name names the same routes.
static int wide_slots(const CgModel& m) {
  return (4 * m.ncon + kThreads - 1) / kThreads;
}

static bool takes_wide(const CgModel& m) {
  return m.nlimit + 4 * m.ncon > 32 * 5 && wide_slots(m) <= 4 &&
         m.nlimit <= kThreads;
}

static CgKernel pick_kernel(const CgModel& m) {
  return m.nlimit + 4 * m.ncon <= 32 * 5 ? cg_kernel<5> : cg_kernel<0>;
}

static CgWideKernel pick_wide_kernel(const CgModel& m) {
  switch (wide_slots(m)) {
    case 1: return cg_wide_kernel<1, 1>;
    case 2: return cg_wide_kernel<2, 1>;
    case 3: return cg_wide_kernel<3, 1>;
    default: return cg_wide_kernel<4, 1>;
  }
}

// The kernel of a system and its shared memory per block.
static const void* route(const CgModel& m, const CgWide& w, size_t* smem) {
  if (takes_wide(m)) {
    *smem = (size_t)make_wlayout(w).total * sizeof(float);
    return (const void*)pick_wide_kernel(m);
  }
  const CgKernel fn = pick_kernel(m);
  *smem = (size_t)make_layout(m.nv, m.ncon, m.nlimit, fn != cg_kernel<0>)
              .total * sizeof(float);
  return (const void*)fn;
}

// out4 = registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM.
extern "C" int cg_resources(CgModel m, CgWide w, int* out4) {
  size_t smem = 0;
  const void* fn = route(m, w, &smem);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  out4[0] = a.numRegs;
  out4[1] = (int)a.localSizeBytes;
  out4[2] = (int)(smem + a.sharedSizeBytes);
  out4[3] = blocks;
  return (int)err;
}

extern "C" int cg_launch(CgModel m, CgWide w, CgIn in, CgOut out, int batch,
                         void* stream, int skip) {
  // the matvecs need a thread per dof and leave a warp for J p
  if (kThreads < 32 * ((m.nv + 31) / 32 + 1)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const void* fn = route(m, w, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (takes_wide(m))
    ((CgWideKernel)fn)<<<batch, kThreads, smem, st>>>(w, in, out, skip);
  else
    ((CgKernel)fn)<<<batch, kThreads, smem, st>>>(m, in, out, skip);
  return (int)cudaGetLastError();
}
