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
// What bounds it on an H100: per env it reads qM and qMinv (2 * 73 * 73
// floats, ~43 KB) plus ~2 KB of constraint data and writes ~1 KB; the
// arithmetic is ~0.2 MFLOP (two 73x73 matvecs and two factored J products
// per iteration).  So the card's limits are a few microseconds at
// B = 1024; what this first version pays for is the chain of dependent
// block-wide reductions and barriers (~100 per iteration).
//
// Design: qM and qMinv are staged once into shared memory, so every matvec
// (threads over rows) reads shared memory; J p and J^T f are chain sums over
// cdof taken from the static chain masks, with threads over
// (side, contact, spatial component) and then over contacts or dofs; dot
// products and line-search sums are block reductions (warp shuffles, then
// one pass over the warp sums in fixed order, so results are
// deterministic).  M(x - a) is updated incrementally, as the TPU kernel
// does.  fp32 throughout; the kernel allocates nothing and runs on the
// caller's stream.

#include <cuda_runtime.h>

struct CgModel {
  int nv, ncon, nlimit, iters, ls_iters;
  const int* lim_dof;   // (nlimit)
  const float* chain;   // (2, ncon, nv) 0/1: [chain2 | chain1]
};

struct CgIn {
  const float *qM, *qMinv, *x0, *cdof, *g36, *lim_sign, *lim_aref, *lim_D,
      *con_mu, *con_aref, *con_D;
};

struct CgOut {
  float *qacc, *qfrc, *con_f;
};

constexpr int kMaxWarps = 32;

// Sums two values over the block; every thread gets the totals.
__device__ void block_sum2(float a, float b, float* red, float* outa,
                           float* outb) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.0f, sb = 0.0f;
    const int nw = (blockDim.x + 31) >> 5;
    for (int w = 0; w < nw; ++w) {
      sa += red[2 * w];
      sb += red[2 * w + 1];
    }
    red[2 * kMaxWarps] = sa;
    red[2 * kMaxWarps + 1] = sb;
  }
  __syncthreads();
  *outa = red[2 * kMaxWarps];
  *outb = red[2 * kMaxWarps + 1];
  __syncthreads();
}

struct Smem {
  float *M, *Minv, *cdof, *g, *mu, *aref, *D, *lsign, *laref, *lD;
  float *x, *Mxa, *gr, *Mg, *p, *Mp, *tmp;
  float *ljx, *ljp, *lf, *cfx, *cjp, *cf, *side, *red;
};

// J v -> (ljv (nlimit), cjv (ncon, 4)); uses s.side as scratch.
__device__ void jx(const CgModel& m, const Smem& s, const float* v, float* ljv,
                   float* cjv) {
  const int nv = m.nv, nc = m.ncon, tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l < m.nlimit; l += nt) ljv[l] = s.lsign[l] * v[m.lim_dof[l]];
  // side[(sd * nc + c) * 6 + k] = sum_d chain_sd[c][d] cdof[d][k] v[d]
  for (int i = tid; i < 2 * nc * 6; i += nt) {
    const int k = i % 6, c = (i / 6) % nc, sd = i / (6 * nc);
    const float* ch = &m.chain[(sd * nc + c) * nv];
    float acc = 0.0f;
    for (int d = 0; d < nv; ++d)
      if (ch[d] != 0.0f) acc += s.cdof[d * 6 + k] * v[d];
    s.side[i] = acc;
  }
  __syncthreads();
  for (int c = tid; c < nc; c += nt) {
    float base[3];
    for (int f = 0; f < 3; ++f) {
      float acc = 0.0f;
      for (int k = 0; k < 6; ++k)
        acc += s.g[(f * 6 + k) * nc + c] * s.side[c * 6 + k] -
               s.g[(18 + f * 6 + k) * nc + c] * s.side[(nc + c) * 6 + k];
      base[f] = acc;
    }
    const float mu1 = s.mu[c * 2], mu2 = s.mu[c * 2 + 1];
    cjv[c * 4 + 0] = base[0] + mu1 * base[1];
    cjv[c * 4 + 1] = base[0] - mu1 * base[1];
    cjv[c * 4 + 2] = base[0] + mu2 * base[2];
    cjv[c * 4 + 3] = base[0] - mu2 * base[2];
  }
  __syncthreads();
}

// active-set forces of the current jx
__device__ void forces(const CgModel& m, const Smem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l < m.nlimit; l += nt) {
    const float jar = s.ljx[l] - s.laref[l];
    s.lf[l] = jar < 0.0f ? -s.lD[l] * jar : 0.0f;
  }
  for (int r = tid; r < 4 * m.ncon; r += nt) {
    const float jar = s.cfx[r] - s.aref[r];
    s.cf[r] = jar < 0.0f ? -s.D[r] * jar : 0.0f;
  }
  __syncthreads();
}

// out = Mxa - J^T f (the gradient); uses s.side as scratch.
__device__ void grad(const CgModel& m, const Smem& s, float* out) {
  const int nv = m.nv, nc = m.ncon, tid = threadIdx.x, nt = blockDim.x;
  // side[(sd * nc + c) * 6 + k] = sum_f G_sd[f][k][c] fvec[c][f]
  for (int i = tid; i < 2 * nc * 6; i += nt) {
    const int k = i % 6, c = (i / 6) % nc, sd = i / (6 * nc);
    const float* f4 = &s.cf[c * 4];
    const float fv[3] = {f4[0] + f4[1] + f4[2] + f4[3],
                         s.mu[c * 2] * (f4[0] - f4[1]),
                         s.mu[c * 2 + 1] * (f4[2] - f4[3])};
    float acc = 0.0f;
    for (int f = 0; f < 3; ++f) acc += s.g[(sd * 18 + f * 6 + k) * nc + c] * fv[f];
    s.side[i] = acc;
  }
  __syncthreads();
  for (int d = tid; d < nv; d += nt) {
    float u[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < nc; ++c) {
      const float c2 = m.chain[c * nv + d], c1 = m.chain[(nc + c) * nv + d];
      if (c2 != 0.0f)
        for (int k = 0; k < 6; ++k) u[k] += s.side[c * 6 + k];
      if (c1 != 0.0f)
        for (int k = 0; k < 6; ++k) u[k] -= s.side[(nc + c) * 6 + k];
    }
    float jtf = 0.0f;
    for (int l = 0; l < m.nlimit; ++l)
      if (m.lim_dof[l] == d) jtf += s.lsign[l] * s.lf[l];
    for (int k = 0; k < 6; ++k) jtf += s.cdof[d * 6 + k] * u[k];
    out[d] = s.Mxa[d] - jtf;
  }
  __syncthreads();
}

__device__ void matvec(int nv, const float* M, const float* v, float* out) {
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < nv; ++j) acc += M[i * nv + j] * v[j];
    out[i] = acc;
  }
  __syncthreads();
}

__global__ void cg_kernel(CgModel m, CgIn in, CgOut out) {
  extern __shared__ float sm[];
  const int nv = m.nv, nc = m.ncon, nl = m.nlimit;
  const int e = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;

  Smem s;
  float* q = sm;
  s.M = q; q += nv * nv;
  s.Minv = q; q += nv * nv;
  s.cdof = q; q += nv * 6;
  s.g = q; q += 36 * nc;
  s.mu = q; q += 2 * nc;
  s.aref = q; q += 4 * nc;
  s.D = q; q += 4 * nc;
  s.lsign = q; q += nl;
  s.laref = q; q += nl;
  s.lD = q; q += nl;
  s.x = q; q += nv;
  s.Mxa = q; q += nv;
  s.gr = q; q += nv;
  s.Mg = q; q += nv;
  s.p = q; q += nv;
  s.Mp = q; q += nv;
  s.tmp = q; q += nv;
  s.ljx = q; q += nl;
  s.ljp = q; q += nl;
  s.lf = q; q += nl;
  s.cfx = q; q += 4 * nc;
  s.cjp = q; q += 4 * nc;
  s.cf = q; q += 4 * nc;
  s.side = q; q += 12 * nc;
  s.red = q;

  const size_t mo = (size_t)e * nv * nv;
  for (int i = tid; i < nv * nv; i += nt) {
    s.M[i] = in.qM[mo + i];
    s.Minv[i] = in.qMinv[mo + i];
  }
  for (int i = tid; i < nv * 6; i += nt) s.cdof[i] = in.cdof[(size_t)e * nv * 6 + i];
  for (int i = tid; i < 36 * nc; i += nt) s.g[i] = in.g36[(size_t)e * 36 * nc + i];
  for (int i = tid; i < 2 * nc; i += nt) s.mu[i] = in.con_mu[(size_t)e * 2 * nc + i];
  for (int i = tid; i < 4 * nc; i += nt) {
    s.aref[i] = in.con_aref[(size_t)e * 4 * nc + i];
    s.D[i] = in.con_D[(size_t)e * 4 * nc + i];
  }
  for (int i = tid; i < nl; i += nt) {
    s.lsign[i] = in.lim_sign[(size_t)e * nl + i];
    s.laref[i] = in.lim_aref[(size_t)e * nl + i];
    s.lD[i] = in.lim_D[(size_t)e * nl + i];
  }
  for (int i = tid; i < nv; i += nt) {
    s.x[i] = in.x0[(size_t)e * nv + i];
    s.Mxa[i] = 0.0f;  // x starts at qacc_smooth, so M(x - a) starts at 0
  }
  __syncthreads();

  jx(m, s, s.x, s.ljx, s.cfx);
  forces(m, s);
  grad(m, s, s.gr);
  matvec(nv, s.Minv, s.gr, s.Mg);
  for (int i = tid; i < nv; i += nt) s.p[i] = -s.Mg[i];
  float gMg, unused;
  {
    float a = 0.0f;
    for (int i = tid; i < nv; i += nt) a += s.gr[i] * s.Mg[i];
    block_sum2(a, 0.0f, s.red, &gMg, &unused);
  }

  for (int it = 0; it < m.iters; ++it) {
    jx(m, s, s.p, s.ljp, s.cjp);
    matvec(nv, s.M, s.p, s.Mp);
    // exact line search on the piecewise quadratic along p
    float num0, den0;
    {
      float a = 0.0f, b = 0.0f;
      for (int i = tid; i < nv; i += nt) {
        a += s.p[i] * s.Mxa[i];
        b += s.p[i] * s.Mp[i];
      }
      block_sum2(a, b, s.red, &num0, &den0);
    }
    float alpha = 0.0f;
    for (int ls = 0; ls < m.ls_iters; ++ls) {
      float a = 0.0f, b = 0.0f;
      for (int l = tid; l < nl; l += nt) {
        const float jar = s.ljx[l] - s.laref[l], jp = s.ljp[l];
        if (jar + alpha * jp < 0.0f) {
          a += s.lD[l] * jar * jp;
          b += s.lD[l] * jp * jp;
        }
      }
      for (int r = tid; r < 4 * nc; r += nt) {
        const float jar = s.cfx[r] - s.aref[r], jp = s.cjp[r];
        if (jar + alpha * jp < 0.0f) {
          a += s.D[r] * jar * jp;
          b += s.D[r] * jp * jp;
        }
      }
      float num, den;
      block_sum2(a, b, s.red, &num, &den);
      alpha = -(num0 + num) / fmaxf(den0 + den, 1e-12f);
    }
    for (int i = tid; i < nv; i += nt) {
      s.x[i] += alpha * s.p[i];
      s.Mxa[i] += alpha * s.Mp[i];
    }
    for (int l = tid; l < nl; l += nt) s.ljx[l] += alpha * s.ljp[l];
    for (int r = tid; r < 4 * nc; r += nt) s.cfx[r] += alpha * s.cjp[r];
    __syncthreads();
    forces(m, s);
    grad(m, s, s.tmp);                 // g_new
    matvec(nv, s.Minv, s.tmp, s.Mp);   // Mg_new; Mp is spent by now
    float gnMgn, gMgn;
    {
      float a = 0.0f, b = 0.0f;
      for (int i = tid; i < nv; i += nt) {
        a += s.tmp[i] * s.Mp[i];
        b += s.gr[i] * s.Mp[i];
      }
      block_sum2(a, b, s.red, &gnMgn, &gMgn);
    }
    const float beta = fmaxf(0.0f, (gnMgn - gMgn) / fmaxf(gMg, 1e-12f));
    for (int i = tid; i < nv; i += nt) {
      s.p[i] = -s.Mp[i] + beta * s.p[i];
      s.gr[i] = s.tmp[i];
    }
    gMg = gnMgn;
    __syncthreads();
  }

  forces(m, s);
  for (int i = tid; i < nv; i += nt) s.Mxa[i] = 0.0f;
  __syncthreads();
  grad(m, s, s.tmp);  // = -J^T f with Mxa zeroed
  for (int i = tid; i < nv; i += nt) {
    out.qacc[(size_t)e * nv + i] = s.x[i];
    out.qfrc[(size_t)e * nv + i] = -s.tmp[i];
  }
  for (int r = tid; r < 4 * nc; r += nt) out.con_f[(size_t)e * 4 * nc + r] = s.cf[r];
}

extern "C" size_t cg_smem_bytes(CgModel m) {
  const size_t n = 2 * (size_t)m.nv * m.nv + 6 * (size_t)m.nv +
                   (36 + 2 + 4 + 4) * (size_t)m.ncon + 3 * (size_t)m.nlimit +
                   7 * (size_t)m.nv + 3 * (size_t)m.nlimit +
                   12 * (size_t)m.ncon + 12 * (size_t)m.ncon +
                   2 * kMaxWarps + 2;
  return n * sizeof(float);
}

extern "C" int cg_launch(CgModel m, CgIn in, CgOut out, int batch,
                         int threads, void* stream) {
  if (threads > 32 * kMaxWarps || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = cg_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      cg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cg_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(m, in, out);
  return (int)cudaGetLastError();
}
