// Pair sweeps of the 2-D bucket layout: density, momentum, the Hopkins
// pressure root and momentum, the Pavelka continuity and fused momentum +
// entropy sweeps, and the Colagrossi packing's gradient sum.
//
// Replaces the Pallas pair-sweep harness of
// sph_mountain_waves_tpu/ops/pallas_pairs.py (make_pair_kernel_fn /
// _make_pair_kernel, the one pl.pallas_call) with the bodies of
// weighted_w_pass(ker_h="p")/density_pass, momentum_pass (2-D),
// weighted_w_pass(ker_h="sym")/pressure_pass, hopkins_momentum_pass
// (background_split on and off), pavelka_mass_pass and
// pavelka_momentum_entropy_pass. gamma_grad_sweep has no Pallas counterpart:
// it is the pair sum of utils/packing.py::colagrossi_packing (find_gGamma),
// which the reference leaves to XLA.
//
// Layout: every field is an f32 plane [cap, C+1], slot (k, c) at k*(C+1)+c,
// C = nx*ny cells row-major with x minor, column C the trash column. Plane 0
// is the occupancy (1.0 = occupied). Every output is one [cap, C+1] plane.
//
// Design: one thread per p slot (k, c), threads along c so that loads are
// coalesced. An empty p slot (and the trash column) writes 0 and exits. An
// occupied one walks q ranks kq < kmax[row] (the stencil band's largest
// occupancy, pallas_pairs.row_kmax) and, for each, the 9 stencil cells inside
// the grid (dj-major); a pair counts when the q slot is occupied, r^2 <= h^2
// and, unless the sweep includes the self pair, q != p. Grid edges are bounds
// checks, not pads. For each kq the 9 contributions are summed in registers
// and then added to the accumulator: the Pallas kernel's order, so the plain
// PyTorch twin agrees to rounding and reruns are bitwise identical (no
// atomics, one store per output).
//
// Built with --fmad=false so that no multiply-add is contracted: each
// operation rounds as in the twin. fast_math replaces the divides of the
// momentum bodies (three in momentum, five in the Hopkins momentum, five in
// the fused Pavelka sweep) and of the Pavelka continuity (one, or two with
// the kernel-less diffusion) by a multiply with rcp.approx.ftz.f32; the
// pressure root and the packing's gradient keep their exact divides, as the
// reference's do.
//
// What bounds it on an H100: per occupied p slot about 9*kmax q slots of 4
// (packing gradient), 5 (density, pressure), 9 (Pavelka continuity), 10
// (momentum), 11/13 (Hopkins momentum) or 12 (fused Pavelka) f32 fields are
// read; neighbouring threads share them, so most reads hit L1/L2. Memory
// traffic and occupancy bound the sweep, not FLOPs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct Layout {
  int cap;   // q/p ranks per cell
  int nx;    // cells along x (minor)
  int ny;    // cells along y
  float h2;  // pair cutoff squared
};

template <int NIN, int NOUT>
struct Planes {
  const float* in[NIN];
  float* out[NOUT];
};

template <bool FAST>
__device__ __forceinline__ float pdiv(float a, float b) {
  if (FAST) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
    return a * r;
  }
  return a / b;
}

// rho_p = sum_q w_q W2(h_p, r); fields: occ, x0, x1, 1/h, w.
struct Density {
  static constexpr int NIN = 5;
  static constexpr int NOUT = 1;
  struct Params {
    float cw;  // 7/pi
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float wq = f.in[4][qi];
    const float r = sqrtf(r2);
    const float hinv = p[3];
    const float x = r * hinv;
    const float t = fmaxf(1.0f - x, 0.0f);
    const float t2 = t * t;
    const float hpow = hinv * hinv;
    const float ker = prm.cw * t2 * t2 * (1.0f + 4.0f * x) * hpow;
    tot[0] += wq * ker;
  }
};

// Dv_p = sum_q -m_q rDW(h_ij, r) (A_p + A_q + [x.v<0] Pi_ij) x_pq with the
// Monaghan term Pi_ij; fields: occ, x0, x1, h, m, v0, v1, rho_f, A=P'/rho^2, c.
template <bool FAST>
struct Momentum {
  static constexpr int NIN = 10;
  static constexpr int NOUT = 2;
  struct Params {
    float dw;      // -140/pi
    float eps;
    float nalpha;  // -alpha
    float beta;
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float hq = f.in[3][qi];
    const float mq = f.in[4][qi];
    const float v0q = f.in[5][qi];
    const float v1q = f.in[6][qi];
    const float rhoq = f.in[7][qi];
    const float aq = f.in[8][qi];
    const float cq = f.in[9][qi];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (p[3] + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = prm.dw * t * t * t * (hinv2 * hinv2);
    const float dv0 = p[5] - v0q;
    const float dv1 = p[6] - v1q;
    const float dot = d0 * dv0 + d1 * dv1;
    const float c_ij = 0.5f * (p[9] + cq);
    const float rho_ij = 0.5f * (p[7] + rhoq);
    const float mu = pdiv<FAST>(h_ij * dot, r2 + prm.eps * h_ij * h_ij);
    const float pi = pdiv<FAST>(prm.nalpha * c_ij * mu + prm.beta * mu * mu, rho_ij);
    const float s = -mq * ker * (p[8] + aq + (dot < 0.0f ? pi : 0.0f));
    tot[0] += s * d0;
    tot[1] += s * d1;
  }
};

// Hopkins pressure root P_p = sum_q w_q W2(h_ij, r), h_ij = (h_p + h_q)/2,
// with the exact divides of kernels.wendland2; fields: occ, x0, x1, h,
// w = m A^(1/gamma).
struct Pressure {
  static constexpr int NIN = 5;
  static constexpr int NOUT = 1;
  struct Params {
    float cw;  // 7/pi
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float hq = f.in[3][qi];
    const float wq = f.in[4][qi];
    const float r = sqrtf(r2);
    const float hk = 0.5f * (p[3] + hq);
    const float x = r / hk;
    const float t = fmaxf(1.0f - x, 0.0f);
    const float t2 = t * t;
    const float ker = prm.cw * (t2 * t2) * (1.0f + 4.0f * x) / (hk * hk);
    tot[0] += wq * ker;
  }
};

// Hopkins two-kernel momentum: Dv_p = sum_q s x_pq with
//   s = -m_q Ag_p Ag_q (Pe_p rDW(h_p) + Pe_q rDW(h_q))
//       [+ m_q Abg_p Abg_q (Pbe_p rDW(h_p) + Pbe_q rDW(h_q))]   (SPLIT)
//       + [x.v<0] (-m_q) Pi_ij rDW(h_ij)
// fields: occ, x0, x1, h, m, v0, v1, rho_f, c, Ag = A^(1/gamma),
// Pe = max(P, P_floor)^(1-2/gamma) and, with SPLIT, Abg = A_bg^(1/gamma),
// Pbe = max(P_bg, P_floor)^(1-2/gamma).
template <bool FAST, bool SPLIT>
struct Hopkins {
  static constexpr int NIN = SPLIT ? 13 : 11;
  static constexpr int NOUT = 2;
  struct Params {
    float dw;      // -140/pi
    float eps;
    float nalpha;  // -alpha
    float beta;
  };
  __device__ static float rdw(float h, float r, float dw) {
    const float hinv = pdiv<FAST>(1.0f, h);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    return dw * t * t * t * (hinv2 * hinv2);
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float hq = f.in[3][qi];
    const float mq = f.in[4][qi];
    const float v0q = f.in[5][qi];
    const float v1q = f.in[6][qi];
    const float rhoq = f.in[7][qi];
    const float cq = f.in[8][qi];
    const float agq = f.in[9][qi];
    const float peq = f.in[10][qi];
    const float r = sqrtf(r2);
    const float ker_i = rdw(p[3], r, prm.dw);
    const float ker_j = rdw(hq, r, prm.dw);
    float s = -mq * p[9] * agq * (p[10] * ker_i + peq * ker_j);
    if constexpr (SPLIT) {
      const float abq = f.in[11][qi];
      const float pbq = f.in[12][qi];
      s = s + mq * p[11] * abq * (p[12] * ker_i + pbq * ker_j);
    }
    const float dv0 = p[5] - v0q;
    const float dv1 = p[6] - v1q;
    const float dot = d0 * dv0 + d1 * dv1;
    const float h_ij = 0.5f * (p[3] + hq);
    const float ker = rdw(h_ij, r, prm.dw);
    const float c_ij = 0.5f * (p[8] + cq);
    const float rho_ij = 0.5f * (p[7] + rhoq);
    const float mu = pdiv<FAST>(h_ij * dot, r2 + prm.eps * h_ij * h_ij);
    const float pi = pdiv<FAST>(prm.nalpha * c_ij * mu + prm.beta * mu * mu, rho_ij);
    const float visc = (dot < 0.0f ? 1.0f : 0.0f) * (-mq) * pi * ker;
    s = s + visc;
    tot[0] += s * d0;
    tot[1] += s * d1;
  }
};

// Pavelka continuity: Drho_p = sum_q rho_p ker (x_pq . v_pq) + fl_p fl_q diff,
// ker = wq_q rDW(h_ij, r), with diff = 2 nu (rho_p - rho_q) ker (FIXED, the
// Molteni-Colagrossi form) or the reference's kernel-less
// (2 nu / rho_p)(rho_p - rho_q); fields: occ, x0, x1, h, v0, v1, rho_f,
// wq = m/rho_f, fl = [type == FLUID].
template <bool FAST, bool FIXED>
struct PavelkaMass {
  static constexpr int NIN = 9;
  static constexpr int NOUT = 1;
  struct Params {
    float dw;      // -140/pi
    float two_nu;  // 2 nu
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float hq = f.in[3][qi];
    const float v0q = f.in[4][qi];
    const float v1q = f.in[5][qi];
    const float rhoq = f.in[6][qi];
    const float wq = f.in[7][qi];
    const float flq = f.in[8][qi];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (p[3] + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = wq * prm.dw * t * t * t * (hinv2 * hinv2);
    const float dot = d0 * (p[4] - v0q) + d1 * (p[5] - v1q);
    const float conv = p[6] * ker * dot;
    float diff;
    if constexpr (FIXED) {
      diff = prm.two_nu * (p[6] - rhoq) * ker;
    } else {
      diff = pdiv<FAST>(prm.two_nu, p[6]) * (p[6] - rhoq);
    }
    tot[0] += conv + (p[8] * flq) * diff;
  }
};

// Pavelka fused momentum + entropy production: with ker = wq_q rDW(h_ij, r)
// and dot = x_pq . v_pq,
//   Dv_p = sum_q (-rho_p ker (Pt_p + Pt_q)
//                 + ((8 rho_p ker mu)/(rho_p rho_q)) dot
//                   / (r^2 + 0.0025 (h_p + h_q)^2)) x_pq
//   dS_p = sum_q ((-4 m_p m_q ker mu)/(T_p rho_q)) dot^2
//                / (r^2 + 0.01 h_p h_q) dt fl_p fl_q
// fields: occ, x0, x1, h, m, v0, v1, rho_f, wq = m/rho_f, Pt = P/rho_f^2,
// T_f, fl = [type == FLUID]. rho_f and T_f are non-zero on every slot.
template <bool FAST>
struct PavelkaMomentumEntropy {
  static constexpr int NIN = 12;
  static constexpr int NOUT = 3;
  struct Params {
    float dw;  // -140/pi
    float mu;
    float dt;
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float hq = f.in[3][qi];
    const float mq = f.in[4][qi];
    const float v0q = f.in[5][qi];
    const float v1q = f.in[6][qi];
    const float rhoq = f.in[7][qi];
    const float wq = f.in[8][qi];
    const float ptq = f.in[9][qi];
    const float flq = f.in[11][qi];
    const float hp = p[3];
    const float rhop = p[7];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (hp + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = wq * prm.dw * t * t * t * (hinv2 * hinv2);
    const float dot = d0 * (p[5] - v0q) + d1 * (p[6] - v1q);
    const float du = -rhop * ker * (p[9] + ptq);
    const float hs = hp + hq;
    const float visc = pdiv<FAST>(
        pdiv<FAST>(rhop * 8.0f * ker * prm.mu, rhop * rhoq) * dot,
        r2 + 0.0025f * (hs * hs));
    const float s = du + visc;
    const float ds = (pdiv<FAST>(
        pdiv<FAST>(-4.0f * p[4] * mq * ker * prm.mu, p[10] * rhoq) * dot * dot,
        r2 + 0.01f * hp * hq) * prm.dt) * (p[11] * flq);
    tot[0] += s * d0;
    tot[1] += s * d1;
    tot[2] += ds;
  }
};

// Colagrossi packing gradient: gGamma_p = sum_q coef t^3 / h_p^4 x_pq,
// t = max(1 - r/h_p, 0), coef = V0 (-140/pi), exact divide; fields: occ, x0,
// x1, h. Includes the self pair, whose term is exactly 0.
struct GammaGrad {
  static constexpr int NIN = 4;
  static constexpr int NOUT = 2;
  struct Params {
    float coef;  // V0 * (-140/pi)
  };
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float hinv = 1.0f / p[3];
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = prm.coef * t * t * t * (hinv2 * hinv2);
    tot[0] += ker * d0;
    tot[1] += ker * d1;
  }
};

template <class Body, bool SELF>
__global__ void __launch_bounds__(kBlock)
pair_sweep(Planes<Body::NIN, Body::NOUT> f, const int* __restrict__ kmax,
           Layout g, typename Body::Params prm) {
  const int C = g.nx * g.ny;
  const int c = blockIdx.x * kBlock + threadIdx.x;
  const int k = blockIdx.y;
  if (c > C) return;
  const int64_t ld = C + 1;
  const int64_t ps = k * ld + c;
  float acc[Body::NOUT];
#pragma unroll
  for (int o = 0; o < Body::NOUT; ++o) acc[o] = 0.0f;

  if (c < C && f.in[0][ps] > 0.5f) {
    float p[Body::NIN];
#pragma unroll
    for (int i = 0; i < Body::NIN; ++i) p[i] = f.in[i][ps];
    const int cy = c / g.nx;
    const int cx = c - cy * g.nx;
    const int kend = kmax[cy];
    for (int kq = 0; kq < kend; ++kq) {
      float tot[Body::NOUT];
#pragma unroll
      for (int o = 0; o < Body::NOUT; ++o) tot[o] = 0.0f;
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        const int qy = cy + dj;
        if (qy < 0 || qy >= g.ny) continue;
#pragma unroll
        for (int di = -1; di <= 1; ++di) {
          const int qx = cx + di;
          if (qx < 0 || qx >= g.nx) continue;
          if (!SELF && di == 0 && dj == 0 && kq == k) continue;
          const int64_t qi = kq * ld + (int64_t)qy * g.nx + qx;
          if (!(f.in[0][qi] > 0.5f)) continue;
          const float d0 = p[1] - f.in[1][qi];
          const float d1 = p[2] - f.in[2][qi];
          const float r2 = d0 * d0 + d1 * d1;
          if (!(r2 <= g.h2)) continue;
          Body::pair(p, f, qi, d0, d1, r2, prm, tot);
        }
      }
#pragma unroll
      for (int o = 0; o < Body::NOUT; ++o) acc[o] += tot[o];
    }
  }
#pragma unroll
  for (int o = 0; o < Body::NOUT; ++o) f.out[o][ps] = acc[o];
}

template <class Body, bool SELF>
int launch(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
           const Layout& g, const typename Body::Params& prm,
           cudaStream_t stream) {
  const int columns = g.nx * g.ny + 1;
  const dim3 grid((columns + kBlock - 1) / kBlock, g.cap);
  pair_sweep<Body, SELF><<<grid, kBlock, 0, stream>>>(f, kmax, g, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pair_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Inputs and outputs are [cap, nx*ny+1] f32 planes; kmax is int32 [ny].
int density_sweep(const float* occ, const float* x0, const float* x1,
                  const float* hinv, const float* w, const int* kmax,
                  float* rho, int cap, int nx, int ny, float h2,
                  int self_pair, float cw, void* stream) {
  Planes<Density::NIN, Density::NOUT> f{{occ, x0, x1, hinv, w}, {rho}};
  const Layout g{cap, nx, ny, h2};
  const Density::Params prm{cw};
  auto s = static_cast<cudaStream_t>(stream);
  return self_pair ? launch<Density, true>(f, kmax, g, prm, s)
                   : launch<Density, false>(f, kmax, g, prm, s);
}

int momentum_sweep(const float* occ, const float* x0, const float* x1,
                   const float* h, const float* m, const float* v0,
                   const float* v1, const float* rho, const float* aterm,
                   const float* cs, const int* kmax, float* dv0, float* dv1,
                   int cap, int nx, int ny, float h2, float dw, float eps,
                   float nalpha, float beta, int fast_math, void* stream) {
  const Layout g{cap, nx, ny, h2};
  auto s = static_cast<cudaStream_t>(stream);
  if (fast_math) {
    Planes<Momentum<true>::NIN, Momentum<true>::NOUT> f{
        {occ, x0, x1, h, m, v0, v1, rho, aterm, cs}, {dv0, dv1}};
    return launch<Momentum<true>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s);
  }
  Planes<Momentum<false>::NIN, Momentum<false>::NOUT> f{
      {occ, x0, x1, h, m, v0, v1, rho, aterm, cs}, {dv0, dv1}};
  return launch<Momentum<false>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s);
}

int pressure_sweep(const float* occ, const float* x0, const float* x1,
                   const float* h, const float* w, const int* kmax,
                   float* proot, int cap, int nx, int ny, float h2,
                   int self_pair, float cw, void* stream) {
  Planes<Pressure::NIN, Pressure::NOUT> f{{occ, x0, x1, h, w}, {proot}};
  const Layout g{cap, nx, ny, h2};
  const Pressure::Params prm{cw};
  auto s = static_cast<cudaStream_t>(stream);
  return self_pair ? launch<Pressure, true>(f, kmax, g, prm, s)
                   : launch<Pressure, false>(f, kmax, g, prm, s);
}

// abg and pbe are read only with background_split (they may be null
// otherwise).
int hopkins_momentum_sweep(const float* occ, const float* x0, const float* x1,
                           const float* h, const float* m, const float* v0,
                           const float* v1, const float* rho, const float* cs,
                           const float* ag, const float* pe, const float* abg,
                           const float* pbe, const int* kmax, float* dv0,
                           float* dv1, int cap, int nx, int ny, float h2,
                           float dw, float eps, float nalpha, float beta,
                           int background_split, int fast_math, void* stream) {
  const Layout g{cap, nx, ny, h2};
  auto s = static_cast<cudaStream_t>(stream);
  if (background_split) {
    Planes<13, 2> f{{occ, x0, x1, h, m, v0, v1, rho, cs, ag, pe, abg, pbe},
                    {dv0, dv1}};
    return fast_math
        ? launch<Hopkins<true, true>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s)
        : launch<Hopkins<false, true>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s);
  }
  Planes<11, 2> f{{occ, x0, x1, h, m, v0, v1, rho, cs, ag, pe}, {dv0, dv1}};
  return fast_math
      ? launch<Hopkins<true, false>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s)
      : launch<Hopkins<false, false>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s);
}

int pavelka_mass_sweep(const float* occ, const float* x0, const float* x1,
                       const float* h, const float* v0, const float* v1,
                       const float* rho, const float* wq, const float* fluid,
                       const int* kmax, float* drho, int cap, int nx, int ny,
                       float h2, float dw, float two_nu, int fixed_diffusion,
                       int fast_math, void* stream) {
  Planes<9, 1> f{{occ, x0, x1, h, v0, v1, rho, wq, fluid}, {drho}};
  const Layout g{cap, nx, ny, h2};
  auto s = static_cast<cudaStream_t>(stream);
  if (fixed_diffusion) {
    return fast_math
        ? launch<PavelkaMass<true, true>, false>(f, kmax, g, {dw, two_nu}, s)
        : launch<PavelkaMass<false, true>, false>(f, kmax, g, {dw, two_nu}, s);
  }
  return fast_math
      ? launch<PavelkaMass<true, false>, false>(f, kmax, g, {dw, two_nu}, s)
      : launch<PavelkaMass<false, false>, false>(f, kmax, g, {dw, two_nu}, s);
}

int pavelka_momentum_entropy_sweep(
    const float* occ, const float* x0, const float* x1, const float* h,
    const float* m, const float* v0, const float* v1, const float* rho,
    const float* wq, const float* pterm, const float* temp,
    const float* fluid, const int* kmax, float* dv0, float* dv1, float* ds,
    int cap, int nx, int ny, float h2, float dw, float mu, float dt,
    int fast_math, void* stream) {
  const Layout g{cap, nx, ny, h2};
  auto s = static_cast<cudaStream_t>(stream);
  Planes<12, 3> f{{occ, x0, x1, h, m, v0, v1, rho, wq, pterm, temp, fluid},
                  {dv0, dv1, ds}};
  return fast_math
      ? launch<PavelkaMomentumEntropy<true>, false>(f, kmax, g, {dw, mu, dt}, s)
      : launch<PavelkaMomentumEntropy<false>, false>(f, kmax, g, {dw, mu, dt}, s);
}

int gamma_grad_sweep(const float* occ, const float* x0, const float* x1,
                     const float* h, const int* kmax, float* g0, float* g1,
                     int cap, int nx, int ny, float h2, float coef,
                     void* stream) {
  Planes<GammaGrad::NIN, GammaGrad::NOUT> f{{occ, x0, x1, h}, {g0, g1}};
  const Layout g{cap, nx, ny, h2};
  return launch<GammaGrad, true>(f, kmax, g, {coef},
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
