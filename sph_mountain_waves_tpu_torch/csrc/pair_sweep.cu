// Pair sweeps of the bucket layout. 2-D: density, momentum, the Hopkins
// pressure root and momentum, the Pavelka continuity and fused momentum +
// entropy sweeps, the Colagrossi packing's gradient sum, the dam-break
// continuity and force, and the legacy (terrain) continuity and force with
// fixed or per-particle h and the fused adiabatic entropy + force sweep, the
// ISPH divergence/viscous sweep, CG matvec and pressure gradient, and the
// Rayleigh-Benard continuity + conduction sweep. 3-D (27 stencil cells):
// density, momentum, and the dam-break continuity and force.
//
// Replaces the Pallas pair-sweep harness of
// sph_mountain_waves_tpu/ops/pallas_pairs.py (make_pair_kernel_fn /
// _make_pair_kernel, the one pl.pallas_call) with the bodies of
// weighted_w_pass(ker_h="p")/density_pass and momentum_pass (2-D and 3-D),
// weighted_w_pass(ker_h="sym")/pressure_pass, hopkins_momentum_pass
// (background_split on and off), pavelka_mass_pass,
// pavelka_momentum_entropy_pass, dambreak_mass_pass and dambreak_force_pass
// (2-D and 3-D), legacy_mass_pass, legacy_force_pass, iso_static_mass_pass,
// iso_static_force_pass and adia_entropy_force_pass (templated on the
// dimension, exported in 2-D only: the legacy schemes are 2-D;
// adia_density_pass is density_sweep with a gated weight),
// isph_div_visc_pass, isph_matvec_prepared/isph_matvec_pass, isph_grad_pass
// and rb_mass_heat_pass (2-D: their only callers are 2-D).
// gamma_grad_sweep has no Pallas counterpart:
// it is the pair sum of utils/packing.py::colagrossi_packing (find_gGamma),
// which the reference leaves to XLA.
//
// Layout: every field is an f32 plane [cap, C+1], slot (k, c) at k*(C+1)+c,
// C = nx*ny (2-D) or nx*ny*nz (3-D) cells with x minor and the last axis
// major, column C the trash column. Plane 0 is the occupancy (1.0 =
// occupied). Every output is one [cap, C+1] plane.
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
// atomics, one store per output). The 3-D sweep (pair_sweep3) is the same
// walk over grid rows (cy, cz), kmax[cz*ny + cy], and 27 cells: plane dk
// outermost, then dj, then di, and r^2 = d0^2 + d1^2 + d2^2 in that order.
//
// Built with --fmad=false so that no multiply-add is contracted: each
// operation rounds as in the twin. fast_math replaces the divides of the
// momentum bodies (three in momentum, five in the Hopkins momentum, five in
// the fused Pavelka sweep) and of the Pavelka continuity (one, or two with
// the kernel-less diffusion) by a multiply with rcp.approx.ftz.f32; the
// pressure root, the packing's gradient and the ISPH spline weight keep their
// exact divides, as the reference's do. In the legacy force bodies fast_math
// takes the viscous divide (and 1/h_p with per-particle h) to rcp.approx.
//
// What bounds it on an H100: per occupied p slot about 9*kmax q slots of 4
// (packing gradient), 5 (density, pressure), 6/7 (legacy continuity), 8-10
// (legacy force), 9 (Pavelka continuity), 10 (momentum, adiabatic entropy +
// force), 11/13 (Hopkins momentum) or 12 (fused Pavelka) f32 fields are
// read (the ISPH matvec and gradient 4, the ISPH divergence 5, the
// Rayleigh-Benard sweep 7); neighbouring threads share them, so most reads
// hit L1/L2, and memory traffic and occupancy bound the 2-D sweeps, not
// FLOPs. In 3-D a slot tests 27*kmax candidates (216 at cap 8) for the ~25
// pairs inside the cutoff. pair_sweep3 reads each candidate from the planes
// (at least 4 dependent global loads), and its grid runs the p rank
// slowest, so the q planes are read once per p rank: at witch3d's stretch
// size it took 1.45 ms (density) and 1.96 ms (momentum) on an H100, 7 % of
// an operations bound. The 3-D density, momentum and dam-break sweeps
// therefore run pair_sweep3_tiled: a block stages each q rank of its tile's
// 27-cell neighbourhood in shared memory once for all p ranks (occupancy
// and coordinates as one float4, the body's q planes as scalars), walks the
// q ranks to its tile's own bound, keeps pair_sweep3's order of summation
// and so its outputs bit for bit, and uses no TMA (the [cap, C+1] row
// stride is not a multiple of 16 bytes). The density and momentum take 0.65
// and 0.99 ms there (15 and 14 % of the bound); their candidate loop (a
// 16-byte shared load, the distance and its test), not the staging, paces
// them (PERF.md has the breakdown, and the dam-break sweeps' times). The
// flagship density (and the adiabatic density on it) and momentum, the
// Hopkins pressure root and momentum, the two Pavelka sweeps, the packing
// gradient, the terrain continuity and force with fixed h and with
// per-particle h, the fused adiabatic entropy + force sweep, the ISPH CG
// matvec, divergence/viscous sweep and pressure gradient, the dam-break
// continuity and force and the Rayleigh-Benard continuity + conduction run
// the same design in 2-D, pair_sweep_tiled (9 cells); the density, the
// pressure root and the packing gradient count the self pair there. No path
// launches pair_sweep: it is the "_direct" yardstick of every 2-D export.

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

// q's fields as the accessor bodies read them (the 3-D bodies, the
// dam-break bodies in 2-D, the 2-D density and momentum, the Hopkins pressure
// root and momentum, the Pavelka bodies, the packing gradient, the legacy
// continuity and force, the fused adiabatic sweep, the ISPH
// divergence/viscous sweep, matvec and gradient and the Rayleigh-Benard
// body): q[i]
// is plane i at q's slot. PlaneQ reads the planes (pair_sweep, pair_sweep3);
// StagedQ reads the copy that pair_sweep3_tiled
// staged in shared memory, planes lo.. at ex[(i - lo) * nc + s]; StagedQ2
// the copy that pair_sweep_tiled staged: planes 0-3 (occupancy, x0, x1 and
// plane 3) as the candidate's float4 c4, the planes of the body's QMASK as
// scalars, the j-th of them at ex[j * nc + s].
template <int NIN, int NOUT>
struct PlaneQ {
  const Planes<NIN, NOUT>& f;
  int64_t qi;
  __device__ float operator[](int i) const { return f.in[i][qi]; }
};

struct StagedQ {
  const float* ex;
  int nc;
  int s;
  int lo;
  __device__ float operator[](int i) const { return ex[(i - lo) * nc + s]; }
};

// The scalar planes a 2-D tiled body stages (the set bits of its QMASK, all
// above plane 3): how many, the j-th of them, and plane i's place among
// them. Called with constants, they fold at compile time.
__host__ __device__ constexpr int staged_count(unsigned mask) {
  int n = 0;
  for (int i = 4; i < 32; ++i) n += (mask >> i) & 1u;
  return n;
}

__host__ __device__ constexpr int staged_plane(unsigned mask, int j) {
  for (int i = 4; i < 32; ++i)
    if (((mask >> i) & 1u) && j-- == 0) return i;
  return -1;
}

__host__ __device__ constexpr int staged_slot(unsigned mask, int plane) {
  int n = 0;
  for (int i = 4; i < plane; ++i) n += (mask >> i) & 1u;
  return n;
}

template <unsigned QMASK>
struct StagedQ2 {
  float4 c4;
  const float* ex;
  int nc;
  int s;
  __device__ float operator[](int i) const {
    return i == 0 ? c4.x : i == 1 ? c4.y : i == 2 ? c4.z : i == 3 ? c4.w
                                 : ex[staged_slot(QMASK, i) * nc + s];
  }
};

// rho_p = sum_q w_q W2(h_p, r); fields: occ, x0, x1, 1/h, w. q's planes
// read by the body beyond the occupancy and position: QMASK (w: plane 4; q's
// 1/h rides in the staged float4 unread).
struct Density {
  static constexpr int NIN = 5;
  static constexpr int NOUT = 1;
  static constexpr unsigned QMASK = 0x10u;
  struct Params {
    float cw;  // 7/pi
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float wq = q[4];
    const float r = sqrtf(r2);
    const float hinv = p[3];
    const float x = r * hinv;
    const float t = fmaxf(1.0f - x, 0.0f);
    const float t2 = t * t;
    const float hpow = hinv * hinv;
    const float ker = prm.cw * t2 * t2 * (1.0f + 4.0f * x) * hpow;
    tot[0] += wq * ker;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Dv_p = sum_q -m_q rDW(h_ij, r) (A_p + A_q + [x.v<0] Pi_ij) x_pq with the
// Monaghan term Pi_ij; fields: occ, x0, x1, h, m, v0, v1, rho_f, A=P'/rho^2, c.
// q's planes read by the body beyond the occupancy and position: h and QMASK
// (m, v0, v1, rho_f, A, c: planes 4-9).
template <bool FAST>
struct Momentum {
  static constexpr int NIN = 10;
  static constexpr int NOUT = 2;
  static constexpr unsigned QMASK = 0x3F0u;
  struct Params {
    float dw;      // -140/pi
    float eps;
    float nalpha;  // -alpha
    float beta;
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[3];
    const float mq = q[4];
    const float v0q = q[5];
    const float v1q = q[6];
    const float rhoq = q[7];
    const float aq = q[8];
    const float cq = q[9];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (p[3] + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = prm.dw * t * t * t * (hinv2 * hinv2);
    const float dv0 = p[5] - v0q;
    const float dv1 = p[6] - v1q;
    const float dot = d[0] * dv0 + d[1] * dv1;
    const float c_ij = 0.5f * (p[9] + cq);
    const float rho_ij = 0.5f * (p[7] + rhoq);
    const float mu = pdiv<FAST>(h_ij * dot, r2 + prm.eps * h_ij * h_ij);
    const float pi = pdiv<FAST>(prm.nalpha * c_ij * mu + prm.beta * mu * mu, rho_ij);
    const float s = -mq * ker * (p[8] + aq + (dot < 0.0f ? pi : 0.0f));
    tot[0] += s * d[0];
    tot[1] += s * d[1];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Hopkins pressure root P_p = sum_q w_q W2(h_ij, r), h_ij = (h_p + h_q)/2,
// with the exact divides of kernels.wendland2; fields: occ, x0, x1, h,
// w = m A^(1/gamma). q's planes read by the body beyond the occupancy and
// position: h and QMASK (w: plane 4).
struct Pressure {
  static constexpr int NIN = 5;
  static constexpr int NOUT = 1;
  static constexpr unsigned QMASK = 0x10u;
  struct Params {
    float cw;  // 7/pi
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[3];
    const float wq = q[4];
    const float r = sqrtf(r2);
    const float hk = 0.5f * (p[3] + hq);
    const float x = r / hk;
    const float t = fmaxf(1.0f - x, 0.0f);
    const float t2 = t * t;
    const float ker = prm.cw * (t2 * t2) * (1.0f + 4.0f * x) / (hk * hk);
    tot[0] += wq * ker;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Hopkins two-kernel momentum: Dv_p = sum_q s x_pq with
//   s = -m_q Ag_p Ag_q (Pe_p rDW(h_p) + Pe_q rDW(h_q))
//       [+ m_q Abg_p Abg_q (Pbe_p rDW(h_p) + Pbe_q rDW(h_q))]   (SPLIT)
//       + [x.v<0] (-m_q) Pi_ij rDW(h_ij)
// fields: occ, x0, x1, h, m, v0, v1, rho_f, c, Ag = A^(1/gamma),
// Pe = max(P, P_floor)^(1-2/gamma) and, with SPLIT, Abg = A_bg^(1/gamma),
// Pbe = max(P_bg, P_floor)^(1-2/gamma). q's planes read by the body beyond
// the occupancy and position: h and QMASK (m, v0, v1, rho_f, c, Ag, Pe:
// planes 4-10, and with SPLIT Abg, Pbe: planes 11-12; without it those two
// planes may be null, and QMASK leaves them out).
template <bool FAST, bool SPLIT>
struct Hopkins {
  static constexpr int NIN = SPLIT ? 13 : 11;
  static constexpr int NOUT = 2;
  static constexpr unsigned QMASK = SPLIT ? 0x1FF0u : 0x7F0u;
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
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[3];
    const float mq = q[4];
    const float v0q = q[5];
    const float v1q = q[6];
    const float rhoq = q[7];
    const float cq = q[8];
    const float agq = q[9];
    const float peq = q[10];
    const float r = sqrtf(r2);
    const float ker_i = rdw(p[3], r, prm.dw);
    const float ker_j = rdw(hq, r, prm.dw);
    float s = -mq * p[9] * agq * (p[10] * ker_i + peq * ker_j);
    if constexpr (SPLIT) {
      const float abq = q[11];
      const float pbq = q[12];
      s = s + mq * p[11] * abq * (p[12] * ker_i + pbq * ker_j);
    }
    const float dv0 = p[5] - v0q;
    const float dv1 = p[6] - v1q;
    const float dot = d[0] * dv0 + d[1] * dv1;
    const float h_ij = 0.5f * (p[3] + hq);
    const float ker = rdw(h_ij, r, prm.dw);
    const float c_ij = 0.5f * (p[8] + cq);
    const float rho_ij = 0.5f * (p[7] + rhoq);
    const float mu = pdiv<FAST>(h_ij * dot, r2 + prm.eps * h_ij * h_ij);
    const float pi = pdiv<FAST>(prm.nalpha * c_ij * mu + prm.beta * mu * mu, rho_ij);
    const float visc = (dot < 0.0f ? 1.0f : 0.0f) * (-mq) * pi * ker;
    s = s + visc;
    tot[0] += s * d[0];
    tot[1] += s * d[1];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Pavelka continuity: Drho_p = sum_q rho_p ker (x_pq . v_pq) + fl_p fl_q diff,
// ker = wq_q rDW(h_ij, r), with diff = 2 nu (rho_p - rho_q) ker (FIXED, the
// Molteni-Colagrossi form) or the reference's kernel-less
// (2 nu / rho_p)(rho_p - rho_q); fields: occ, x0, x1, h, v0, v1, rho_f,
// wq = m/rho_f, fl = [type == FLUID]. q's planes read by the body beyond the
// occupancy and position: h and QMASK (v0, v1, rho_f, wq, fl: planes 4-8).
template <bool FAST, bool FIXED>
struct PavelkaMass {
  static constexpr int NIN = 9;
  static constexpr int NOUT = 1;
  static constexpr unsigned QMASK = 0x1F0u;
  struct Params {
    float dw;      // -140/pi
    float two_nu;  // 2 nu
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[3];
    const float v0q = q[4];
    const float v1q = q[5];
    const float rhoq = q[6];
    const float wq = q[7];
    const float flq = q[8];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (p[3] + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = wq * prm.dw * t * t * t * (hinv2 * hinv2);
    const float dot = d[0] * (p[4] - v0q) + d[1] * (p[5] - v1q);
    const float conv = p[6] * ker * dot;
    float diff;
    if constexpr (FIXED) {
      diff = prm.two_nu * (p[6] - rhoq) * ker;
    } else {
      diff = pdiv<FAST>(prm.two_nu, p[6]) * (p[6] - rhoq);
    }
    tot[0] += conv + (p[8] * flq) * diff;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
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
// T_f, fl = [type == FLUID]. rho_f and T_f are non-zero on every slot. q's
// planes read by the body beyond the occupancy and position: h and QMASK
// (m, v0, v1, rho_f, wq, Pt, fl: planes 4-9 and 11; T_f is read on the p
// side only).
template <bool FAST>
struct PavelkaMomentumEntropy {
  static constexpr int NIN = 12;
  static constexpr int NOUT = 3;
  static constexpr unsigned QMASK = 0xBF0u;
  struct Params {
    float dw;  // -140/pi
    float mu;
    float dt;
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[3];
    const float mq = q[4];
    const float v0q = q[5];
    const float v1q = q[6];
    const float rhoq = q[7];
    const float wq = q[8];
    const float ptq = q[9];
    const float flq = q[11];
    const float hp = p[3];
    const float rhop = p[7];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (hp + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = wq * prm.dw * t * t * t * (hinv2 * hinv2);
    const float dot = d[0] * (p[5] - v0q) + d[1] * (p[6] - v1q);
    const float du = -rhop * ker * (p[9] + ptq);
    const float hs = hp + hq;
    const float visc = pdiv<FAST>(
        pdiv<FAST>(rhop * 8.0f * ker * prm.mu, rhop * rhoq) * dot,
        r2 + 0.0025f * (hs * hs));
    const float s = du + visc;
    const float ds = (pdiv<FAST>(
        pdiv<FAST>(-4.0f * p[4] * mq * ker * prm.mu, p[10] * rhoq) * dot * dot,
        r2 + 0.01f * hp * hq) * prm.dt) * (p[11] * flq);
    tot[0] += s * d[0];
    tot[1] += s * d[1];
    tot[2] += ds;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Colagrossi packing gradient: gGamma_p = sum_q coef t^3 / h_p^4 x_pq,
// t = max(1 - r/h_p, 0), coef = V0 (-140/pi), exact divide; fields: occ, x0,
// x1, h. Includes the self pair, whose term is exactly 0. The body reads no
// q plane beyond the occupancy and position (QMASK 0: the staged float4
// alone).
struct GammaGrad {
  static constexpr int NIN = 4;
  static constexpr int NOUT = 2;
  static constexpr unsigned QMASK = 0u;
  struct Params {
    float coef;  // V0 * (-140/pi)
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q&, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float hinv = 1.0f / p[3];
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = prm.coef * t * t * t * (hinv2 * hinv2);
    tot[0] += ker * d[0];
    tot[1] += ker * d[1];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};


// 3-D density: rho_p = sum_q w_q W3(h_p, r); fields: occ, x0, x1, x2, 1/h, w.
// q's planes read by the body: QLO..QHI-1 (w only).
struct Density3 {
  static constexpr int NIN = 6;
  static constexpr int NOUT = 1;
  static constexpr int QLO = 5;
  static constexpr int QHI = NIN;
  struct Params {
    float cw;  // 21/(2 pi)
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float wq = q[5];
    const float r = sqrtf(r2);
    const float hinv = p[4];
    const float x = r * hinv;
    const float t = fmaxf(1.0f - x, 0.0f);
    const float t2 = t * t;
    const float hpow = hinv * hinv * hinv;
    const float ker = prm.cw * t2 * t2 * (1.0f + 4.0f * x) * hpow;
    tot[0] += wq * ker;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, const float* d, float r2,
                              const Params& prm, float* tot) {
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// 3-D momentum: the 2-D form on three axes with rDW3 = dw t^3 / h_ij^5;
// fields: occ, x0, x1, x2, h, m, v0, v1, v2, rho_f, A=P'/rho^2, c. q's
// planes read by the body: QLO..QHI-1 (all but the occupancy and position).
template <bool FAST>
struct Momentum3 {
  static constexpr int NIN = 12;
  static constexpr int NOUT = 3;
  static constexpr int QLO = 4;
  static constexpr int QHI = NIN;
  struct Params {
    float dw;      // -210/pi
    float eps;
    float nalpha;  // -alpha
    float beta;
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float hq = q[4];
    const float mq = q[5];
    const float v0q = q[6];
    const float v1q = q[7];
    const float v2q = q[8];
    const float rhoq = q[9];
    const float aq = q[10];
    const float cq = q[11];
    const float r = sqrtf(r2);
    const float h_ij = 0.5f * (p[4] + hq);
    const float hinv = pdiv<FAST>(1.0f, h_ij);
    const float t = fmaxf(1.0f - r * hinv, 0.0f);
    const float hinv2 = hinv * hinv;
    const float ker = prm.dw * t * t * t * (hinv2 * hinv2 * hinv);
    const float dot = d[0] * (p[6] - v0q) + d[1] * (p[7] - v1q)
                      + d[2] * (p[8] - v2q);
    const float c_ij = 0.5f * (p[11] + cq);
    const float rho_ij = 0.5f * (p[9] + rhoq);
    const float mu = pdiv<FAST>(h_ij * dot, r2 + prm.eps * h_ij * h_ij);
    const float pi = pdiv<FAST>(prm.nalpha * c_ij * mu + prm.beta * mu * mu, rho_ij);
    const float s = -mq * ker * (p[10] + aq + (dot < 0.0f ? pi : 0.0f));
    tot[0] += s * d[0];
    tot[1] += s * d[1];
    tot[2] += s * d[2];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, const float* d, float r2,
                              const Params& prm, float* tot) {
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Dam-break continuity with fixed h: Drho_p = sum_q kc t^3 (x_pq . v_pq
// + 2 nu (rho_p - rho_q)), t = max(1 - r/h, 0), kc = m (-C of rDW) / h^(D+2);
// fields: occ, x[D], v[D], rho. No divide. q's planes read by the body: v
// and rho, QLO..QHI-1 for pair_sweep3_tiled; in 2-D plane 3 is v0, which
// pair_sweep_tiled stages in the candidate's float4, so QMASK names the rest
// (planes 4..NIN-1: v1 and rho, 0x30).
template <int D>
struct DamMass {
  static constexpr int NIN = 2 + 2 * D;
  static constexpr int NOUT = 1;
  static constexpr int QLO = 1 + D;
  static constexpr int QHI = 2 + 2 * D;
  static constexpr unsigned QMASK = ((1u << NIN) - 1u) & ~0xFu;
  struct Params {
    float kc;
    float hinv;    // 1/h
    float two_nu;  // 2 nu
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float t = fmaxf(1.0f - r * prm.hinv, 0.0f);
    const float ker = prm.kc * t * t * t;
    float dot = d[0] * (p[1 + D] - q[1 + D]);
#pragma unroll
    for (int a = 1; a < D; ++a) dot += d[a] * (p[1 + D + a] - q[1 + D + a]);
    const float drho = p[1 + 2 * D] - q[1 + 2 * D];
    tot[0] += ker * (dot + prm.two_nu * drho);
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, const float* d, float r2,
                              const Params& prm, float* tot) {
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, f, qi, d, r2, prm, tot);
  }
};

// Dam-break force with fixed h, on FLUID p only (a WALL p slot sums exact
// zeros): Dv_p = sum_q -ker (Pt_p + Pt_q) x_pq + ker visc_c v_pq with
// ker = kc (fl_p t)^3, Pt = P / max(rho, 1e-12)^2, visc_c = 2 mu / rho0^2;
// fields: occ, x[D], v[D], Pt, fl = [type == FLUID]. q's planes read by the
// body: v and Pt, QLO..QHI-1 for pair_sweep3_tiled (fl is read on the p side
// only); in 2-D plane 3 is v0, which pair_sweep_tiled stages in the
// candidate's float4, so QMASK names the rest (planes 4..QHI-1: v1 and Pt,
// 0x30).
template <int D>
struct DamForce {
  static constexpr int NIN = 3 + 2 * D;
  static constexpr int NOUT = D;
  static constexpr int QLO = 1 + D;
  static constexpr int QHI = 2 + 2 * D;
  static constexpr unsigned QMASK = ((1u << QHI) - 1u) & ~0xFu;
  struct Params {
    float kc;
    float hinv;    // 1/h
    float visc_c;  // 2 mu / rho0^2
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float t = fmaxf(1.0f - r * prm.hinv, 0.0f) * p[2 + 2 * D];
    const float ker = prm.kc * t * t * t;
    const float s = -ker * (p[1 + 2 * D] + q[1 + 2 * D]);
    const float w = ker * prm.visc_c;
#pragma unroll
    for (int a = 0; a < D; ++a)
      tot[a] += s * d[a] + w * (p[1 + D + a] - q[1 + D + a]);
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, const float* d, float r2,
                              const Params& prm, float* tot) {
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, f, qi, d, r2, prm, tot);
  }
};

// Constants of the legacy (terrain) bodies, computed in double on the host
// and rounded to f32; each body reads the ones it needs.
struct LegacyParams {
  float kc;      // fixed h0: (-C of rDW) / h0^(D+2); per-particle h: -C of rDW
  float hinv;    // 1/h0 (fixed h0)
  float eps_h2;  // 0.01 h0^2 (fixed h0)
  float mu8;     // 8 mu
  float nmu4dt;  // -4 mu dt (entropy production)
  float nac;     // -alpha c_av (AV)
  float two_av;  // 2 alpha (AV)
  float h0;      // fixed h0 (AV)
};

// Legacy (terrain) continuity: Drho_p = sum_q ker (x_pq . v_pq) with
//   fixed h0 (ADAPTIVE_H false): ker = kc t^3 m_q, t = max(1 - r/h0, 0),
//     kc = (-C of rDW) / h0^(D+2); fields occ, x[D], v[D], m;
//   per-particle h (ADAPTIVE_H true): ker = (dw t^3 / h_p^(D+2)) wq_q,
//     t = max(1 - r/h_p, 0), 1/h_p streamed, wq = m / max(rho, 1e-12) (the
//     caller multiplies the sum by rho_p); fields occ, x[D], 1/h, v[D], wq.
// No divide. q's planes read by the body beyond the occupancy and position:
// v and m (or wq). Plane 3 (v0 with fixed h; 1/h with per-particle h, read
// on the p side only) is the one the tiled sweep stages in the candidate's
// float4, so QMASK names the rest (planes 4..NIN-1): v1 and m with fixed h
// (0x30), v0, v1 and wq with per-particle h (0x70).
template <int D, bool ADAPTIVE_H>
struct LegacyMass {
  static constexpr int VO = ADAPTIVE_H ? 2 + D : 1 + D;  // first v plane
  static constexpr int NIN = VO + D + 1;
  static constexpr int NOUT = 1;
  static constexpr unsigned QMASK = ((1u << NIN) - 1u) & ~0xFu;
  using Params = LegacyParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    float ker;
    if constexpr (ADAPTIVE_H) {
      const float hinv = p[1 + D];
      const float t = fmaxf(1.0f - r * hinv, 0.0f);
      const float h2 = hinv * hinv;
      ker = prm.kc * t * t * t * (D == 2 ? h2 * h2 : h2 * h2 * hinv);
      ker = ker * q[VO + D];
    } else {
      const float t = fmaxf(1.0f - r * prm.hinv, 0.0f);
      ker = prm.kc * t * t * t * q[VO + D];
    }
    float dot = d[0] * (p[VO] - q[VO]);
#pragma unroll
    for (int a = 1; a < D; ++a) dot += d[a] * (p[VO + a] - q[VO + a]);
    tot[0] += ker * dot;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Legacy (terrain) force: Dv_p = sum_q (s + w) x_pq with ker as in
// LegacyMass (m_q for wq_q; per-particle h through 1/h_p = 1/h_p divided in
// the body), dot = x_pq . v_pq and
//   di = dot / (r^2 + 0.01 h0^2)              (fixed h0)
//   di = dot / (r^2 + 0.0025 (h_p + h_q)^2)   (per-particle h)
//   s  = -ker (Pt_p + Pt_q),  w = 8 mu ker ri_p ri_q di
// and, with AV, the Monaghan term on approaching FLUID-FLUID pairs:
//   mu_av = h0 di (fixed) or (h_p + h_q)/2 di,
//   Pi = (-alpha c mu_av + 2 alpha mu_av^2) (ri_p + ri_q)/2,
//   w -= fl_p fl_q [dot < 0] ker Pi.
// Pt = P / max(rho, 1e-12)^2, ri = 1 / max(rho, 1e-12); fields occ, x[D],
// (h,) v[D], m, Pt, ri (, fl = [type == FLUID] with AV). q's planes read by
// the body beyond the occupancy and position: every other one (QMASK:
// planes 4..NIN-1; plane 3, v0 with fixed h and h with per-particle h, is
// the one the tiled sweep stages in the candidate's float4). Without AV the
// FLUID plane is null and not among the NIN planes, so QMASK leaves it out:
// per-particle h stages v0, v1, m, Pt and ri (0x1F0, 5 scalar planes) and,
// with AV, fl (0x3F0, 6).
template <int D, bool ADAPTIVE_H, bool AV, bool FAST>
struct LegacyForce {
  static constexpr int VO = ADAPTIVE_H ? 2 + D : 1 + D;  // first v plane
  static constexpr int MO = VO + D;                      // m, Pt, ri, fl
  static constexpr int NIN = MO + (AV ? 4 : 3);
  static constexpr int NOUT = D;
  static constexpr unsigned QMASK = ((1u << NIN) - 1u) & ~0xFu;
  using Params = LegacyParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    float ker, di, hpq = 0.0f;
    float dot = d[0] * (p[VO] - q[VO]);
#pragma unroll
    for (int a = 1; a < D; ++a) dot += d[a] * (p[VO + a] - q[VO + a]);
    if constexpr (ADAPTIVE_H) {
      const float hp = p[1 + D];
      const float hinv = pdiv<FAST>(1.0f, hp);
      const float t = fmaxf(1.0f - r * hinv, 0.0f);
      const float h2 = hinv * hinv;
      ker = prm.kc * t * t * t * (D == 2 ? h2 * h2 : h2 * h2 * hinv);
      ker = ker * q[MO];
      hpq = hp + q[1 + D];
      di = pdiv<FAST>(dot, r2 + 0.0025f * hpq * hpq);
    } else {
      const float t = fmaxf(1.0f - r * prm.hinv, 0.0f);
      ker = prm.kc * t * t * t * q[MO];
      di = pdiv<FAST>(dot, r2 + prm.eps_h2);
    }
    const float riq = q[MO + 2];
    const float s = -ker * (p[MO + 1] + q[MO + 1]);
    float w = prm.mu8 * ker * p[MO + 2] * riq * di;
    if constexpr (AV) {
      const float both = p[MO + 3] * q[MO + 3];
      const float mu_av = (ADAPTIVE_H ? 0.5f * hpq : prm.h0) * di;
      const float pi = (prm.nac * mu_av + prm.two_av * mu_av * mu_av) * 0.5f
                       * (p[MO + 2] + riq);
      w = w - both * (dot < 0.0f ? 1.0f : 0.0f) * ker * pi;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) tot[a] += (s + w) * d[a];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Adiabatic legacy fused entropy production + force, fixed h0: with
// kerq = kc t^3 m_q, rr = ri_p ri_q and di = dot / (r^2 + 0.01 h0^2),
//   dS_p = sum_q -4 mu dt mTi_p kerq rr dot di fl_p fl_q
//   Dv_p = sum_q (-kerq (Pt_p + Pt_q) + 8 mu kerq rr di [- AV term]) x_pq
// (the force as LegacyForce, ungated but for the AV term); mTi =
// m / max(T, 1e-30). Outputs (dS, Dv[D]); fields occ, x[D], v[D], m, Pt, ri,
// fl, mTi. q's planes read by the body beyond the occupancy and position: v,
// m, Pt, ri and fl (the FLUID gate enters the entropy term with or without
// AV; mTi is read on the p side only). Plane 3, v0 in 2-D, is the one the
// tiled sweep stages in the candidate's float4, so QMASK names v1, m, Pt, ri
// and fl (0x1F0: 5 scalar planes, in both AV forms).
template <int D, bool AV, bool FAST>
struct AdiaEntropyForce {
  static constexpr int VO = 1 + D;  // first v plane
  static constexpr int MO = VO + D; // m, Pt, ri, fl, mTi
  static constexpr int NIN = MO + 5;
  static constexpr int NOUT = 1 + D;
  static constexpr unsigned QMASK = 0x1F0u;  // v1, m, Pt, ri, fl (2-D)
  using Params = LegacyParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float t = fmaxf(1.0f - r * prm.hinv, 0.0f);
    const float kerq = prm.kc * t * t * t * q[MO];
    float dot = d[0] * (p[VO] - q[VO]);
#pragma unroll
    for (int a = 1; a < D; ++a) dot += d[a] * (p[VO + a] - q[VO + a]);
    const float riq = q[MO + 2];
    const float rr = p[MO + 2] * riq;
    const float di = pdiv<FAST>(dot, r2 + prm.eps_h2);
    const float s = -kerq * (p[MO + 1] + q[MO + 1]);
    const float both = p[MO + 3] * q[MO + 3];
    float w = prm.mu8 * kerq * rr * di;
    if constexpr (AV) {
      const float mu_av = prm.h0 * di;
      const float pi = (prm.nac * mu_av + prm.two_av * mu_av * mu_av) * 0.5f
                       * (p[MO + 2] + riq);
      w = w - both * (dot < 0.0f ? 1.0f : 0.0f) * kerq * pi;
    }
    tot[0] += prm.nmu4dt * p[MO + 4] * kerq * rr * dot * di * both;
#pragma unroll
    for (int a = 0; a < D; ++a) tot[1 + a] += (s + w) * d[a];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Constants of the ISPH bodies (fixed h0), computed in double on the host
// and rounded to f32.
struct IsphParams {
  float hinv;  // 1/h0
  float kw;    // -C (1/h0)^8, C = 240/(7 pi): 1/h0^4 folded in
};

// (dw/dr)/r of the 2-D cubic spline at fixed h0:
//   kw (x < 1/2 ? 2 - 3x : max(1 - x, 0)^2 / max(x, 1/2)),  x = r/h0,
// with an exact IEEE divide (the reference has no fast_math form of it).
__device__ __forceinline__ float rd_spline23(float r, const IsphParams& prm) {
  const float x = r * prm.hinv;
  const float inner = 2.0f - 3.0f * x;
  const float tpos = fmaxf(1.0f - x, 0.0f);
  const float outer = tpos * tpos / fmaxf(x, 0.5f);
  return prm.kw * (x < 0.5f ? inner : outer);
}

// ISPH fused divergence/L/lambda + viscous sweep: the raw spline sums
//   sum_q w (x_pq . v_pq, 1, r^2, v_pq[0], v_pq[1]),  w = rD(h0, r);
// fields: occ, x0, x1, v0, v1. The caller applies the physics factors. q's
// planes read by the body beyond the occupancy and position: v; plane 3 is
// v0, which the tiled sweep stages in the candidate's float4, so QMASK names
// v1 alone (plane 4, 0x10).
struct IsphDivVisc {
  static constexpr int NIN = 5;
  static constexpr int NOUT = 5;
  static constexpr unsigned QMASK = 0x10u;
  using Params = IsphParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float w = rd_spline23(sqrtf(r2), prm);
    const float dv0 = p[3] - q[3];
    const float dv1 = p[4] - q[4];
    const float dot = d[0] * dv0 + d[1] * dv1;
    tot[0] += w * dot;
    tot[1] += w;
    tot[2] += w * r2;
    tot[3] += w * dv0;
    tot[4] += w * dv1;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// ISPH CG matvec, off-diagonal part: sum_q rD(h0, r) v_q; fields: occ, x0,
// x1 (prepared once per solve) and the iterate v (streamed per call). q's
// only plane beyond the occupancy and position is v, plane 3: the tiled
// sweep stages it in the candidate's float4 and no scalar plane (QMASK 0).
struct IsphMatvec {
  static constexpr int NIN = 4;
  static constexpr int NOUT = 1;
  static constexpr unsigned QMASK = 0u;
  using Params = IsphParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    tot[0] += rd_spline23(sqrtf(r2), prm) * q[3];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// ISPH pressure-correction gradient: per axis sum_q rD(h0, r) (P_p + P_q)
// x_pq; fields: occ, x0, x1, P. The caller applies -vol/max(rho_bg, 1e-6).
// q's only plane beyond the occupancy and position is P, plane 3: the tiled
// sweep stages it in the candidate's float4 and no scalar plane (QMASK 0).
struct IsphGrad {
  static constexpr int NIN = 4;
  static constexpr int NOUT = 2;
  static constexpr unsigned QMASK = 0u;
  using Params = IsphParams;
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float w = rd_spline23(sqrtf(r2), prm);
    const float s = w * (p[3] + q[3]);
    tot[0] += s * d[0];
    tot[1] += s * d[1];
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
  }
};

// Rayleigh-Benard fused continuity + Cleary-Monaghan conduction, fixed h:
//   Drho_p = sum_q kc t^3 (x_pq . v_pq)
//   DT_p   = sum_q ((2 kappa ri_q) kc t^3) (T_p - T_q)
// t = max(1 - r/h, 0), kc = m (-C of rDW2) / h^4, ri = 1/max(rho, 0.01 rho0)
// (zero on zero-flux wall rows); fields: occ, x0, x1, v0, v1, T, ri. No
// divide. The caller applies the p-side FLUID gate to DT. q's planes read by
// the body beyond the occupancy and position: v, T and ri; plane 3 is v0,
// which the tiled sweep stages in the candidate's float4, so QMASK names the
// rest (planes 4..6: v1, T and ri, 0x70).
struct RbMassHeat {
  static constexpr int NIN = 7;
  static constexpr int NOUT = 2;
  static constexpr unsigned QMASK = 0x70u;
  struct Params {
    float kc;
    float hinv;    // 1/h
    float twokap;  // 2 kappa
  };
  template <class Q>
  __device__ static void pair(const float* p, const Q& q, const float* d,
                              float r2, const Params& prm, float* tot) {
    const float r = sqrtf(r2);
    const float t = fmaxf(1.0f - r * prm.hinv, 0.0f);
    const float ker = prm.kc * t * t * t;
    const float dot = d[0] * (p[3] - q[3]) + d[1] * (p[4] - q[4]);
    const float dT = p[5] - q[5];
    tot[0] += ker * dot;
    tot[1] += prm.twokap * q[6] * ker * dT;
  }
  __device__ static void pair(const float* p, const Planes<NIN, NOUT>& f,
                              int64_t qi, float d0, float d1, float r2,
                              const Params& prm, float* tot) {
    const float d[2] = {d0, d1};
    pair(p, PlaneQ<NIN, NOUT>{f, qi}, d, r2, prm, tot);
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

struct Layout3 {
  int cap;   // q/p ranks per cell
  int nx;    // cells along x (minor)
  int ny;    // cells along y
  int nz;    // cells along z (major)
  float h2;  // pair cutoff squared
};

// The 27-cell sweep: grid rows are (cy, cz), kmax is [nz*ny]. The dk loop is
// kept rolled (9 inlined bodies instead of 27); the order of summation does
// not depend on it.
template <class Body, bool SELF>
__global__ void __launch_bounds__(kBlock)
pair_sweep3(Planes<Body::NIN, Body::NOUT> f, const int* __restrict__ kmax,
            Layout3 g, typename Body::Params prm) {
  const int C = g.nx * g.ny * g.nz;
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
    const int row = c / g.nx;  // cz*ny + cy
    const int cx = c - row * g.nx;
    const int cz = row / g.ny;
    const int cy = row - cz * g.ny;
    const int kend = kmax[row];
    for (int kq = 0; kq < kend; ++kq) {
      float tot[Body::NOUT];
#pragma unroll
      for (int o = 0; o < Body::NOUT; ++o) tot[o] = 0.0f;
#pragma unroll 1
      for (int dk = -1; dk <= 1; ++dk) {
        const int qz = cz + dk;
        if (qz < 0 || qz >= g.nz) continue;
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
          const int qy = cy + dj;
          if (qy < 0 || qy >= g.ny) continue;
#pragma unroll
          for (int di = -1; di <= 1; ++di) {
            const int qx = cx + di;
            if (qx < 0 || qx >= g.nx) continue;
            if (!SELF && di == 0 && dj == 0 && dk == 0 && kq == k) continue;
            const int64_t qi =
                kq * ld + ((int64_t)qz * g.ny + qy) * g.nx + qx;
            if (!(f.in[0][qi] > 0.5f)) continue;
            float d[3];
            d[0] = p[1] - f.in[1][qi];
            d[1] = p[2] - f.in[2][qi];
            d[2] = p[3] - f.in[3][qi];
            const float r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
            if (!(r2 <= g.h2)) continue;
            Body::pair(p, f, qi, d, r2, prm, tot);
          }
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
int launch3(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
            const Layout3& g, const typename Body::Params& prm,
            cudaStream_t stream) {
  const int columns = g.nx * g.ny * g.nz + 1;
  const dim3 grid((columns + kBlock - 1) / kBlock, g.cap);
  pair_sweep3<Body, SELF><<<grid, kBlock, 0, stream>>>(f, kmax, g, prm);
  return static_cast<int>(cudaGetLastError());
}

// The tiled 27-cell sweep of the 3-D density and momentum and of the 3-D
// dam-break continuity and force (pallas_pairs.py dambreak_mass_pass and
// dambreak_force_pass). One block is TX consecutive x-cells of one grid row
// (cy, cz) times every p rank: thread (threadIdx.x, threadIdx.y) = (tx, k)
// owns slot (rank k, cell x0 + tx), so a warp reads consecutive cells of one
// rank. Blocks run x-tiles fastest, then cy, then cz: the three z-planes a
// tile reads stay in L2 for the tiles that share them. The q loop runs to
// kmax[blockIdx.x], the tile's own bound (ops/pair_sweeps.py::tile_kmax: the
// largest count among the (TX+2) x 3 x 3 cells it stages; ranks are packed
// from 0, so every rank past it is empty in all of them). For each q rank
// kq the block stages the (TX+2) x 3 x 3 neighbour cells of that rank in
// shared memory, once for all its p ranks: occupancy and coordinates as one
// float4 per cell (a candidate is one 16-byte shared load), the q planes the
// body reads (Body::QLO..QHI-1) as scalars. The cells' plane offsets are
// computed once per block (cell_off); cells outside the grid are
// zero-filled, so they read as unoccupied. Rank kq+1 is copied with
// cp.async while rank kq is summed (two stages; a barrier between a copy and
// its use, another before a stage is overwritten). The thread of an
// occupied p slot then takes its 27 cells in pair_sweep3's order (dk, dj,
// di), skips an empty q cell before any arithmetic on it, sums the pairs
// into tot and adds tot to acc: the same operations in the same order, and
// the ranks it skips would add exact zeros, so the outputs equal
// pair_sweep3's bit for bit. A tile with no occupied p slot (or kmax 0)
// stages nothing; a ragged last tile masks its spare threads; block 0 writes
// the trash column. No TMA: a plane's row stride, C+1 floats, is not a
// multiple of 16 bytes, and every module shares the [cap, C+1] layout. The
// launch plan (TX and the dynamic shared bytes of the two stages) is
// ops/pair_sweeps.py::_tile_plan; the launch refuses a plan the kernel
// cannot hold.
//
// The dam-break sweeps of collapse3d (N = 103,479, grid 128 x 40 x 24, cap
// 40) fill 2.1 % of their slots. What they must move is the occupancy plane,
// their other input planes at the occupied slots and every output slot:
// 42.2 MB (continuity) and 81.9 MB (force) on an H100, 12.6 and 24.5 us;
// their operations (~2.4e7 occupied candidates, 2.6e6 pairs) take less.
// pair_sweep3 spends a thread on every one of the 4.9 M slots and walks each
// occupied one to its row band's bound (27 ranks for an 8-particle fluid
// cell beside the walls), every candidate a gather from the planes. Here a
// tile (TX = 6 at cap 40) with no occupied slot writes its zeros and stops
// (~90 % of them), the per-tile bound cuts the ranks walked (6.3e7 rank
// walks against 7.1e7), and the candidates are read from shared memory:
// 0.21 and 0.24 ms on an H100 against pair_sweep3's 0.54 and 0.66 ms, 6
// and 10 % of the byte bound, each staged rank now a cp.async round trip
// and two barriers for a block whose occupied ranks fill few of its warps.
constexpr int kTileThreads = 256;  // most threads a tile block takes
constexpr int kTileMaxX = 32;      // most x-cells a tile block takes

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // 4 bytes global -> shared; src-size 0 zero-fills dst and reads nothing
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <class Body, bool SELF>
__global__ void __launch_bounds__(kTileThreads)
pair_sweep3_tiled(Planes<Body::NIN, Body::NOUT> f, const int* __restrict__ kmax,
                  Layout3 g, typename Body::Params prm, int stage_f4) {
  constexpr int NE = Body::QHI - Body::QLO;  // scalar planes staged per cell
  extern __shared__ float4 stage[];
  const int TX = blockDim.x;
  const int W = TX + 2;   // staged cells per (dk, dj) row
  const int nc = 9 * W;   // staged cells per rank
  const int tx = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * TX + tx;
  const int nthreads = TX * blockDim.y;
  const int ntiles = (g.nx + TX - 1) / TX;
  const int row = blockIdx.x / ntiles;  // cz*ny + cy
  const int x0 = (blockIdx.x - row * ntiles) * TX;
  const int cz = row / g.ny;
  const int cy = row - cz * g.ny;
  const int C = g.nx * g.ny * g.nz;
  const int64_t ld = C + 1;
  const bool mine = x0 + tx < g.nx;
  const int64_t ps = k * ld + (int64_t)row * g.nx + x0 + tx;
  if (blockIdx.x == 0 && tx == 0) {
#pragma unroll
    for (int o = 0; o < Body::NOUT; ++o) f.out[o][k * ld + C] = 0.0f;
  }
  float acc[Body::NOUT];
#pragma unroll
  for (int o = 0; o < Body::NOUT; ++o) acc[o] = 0.0f;
  const bool occ = mine && f.in[0][ps] > 0.5f;
  const int kend = kmax[blockIdx.x];
  // each staged cell's offset in a plane (-1: outside the grid), the same
  // for every rank: (dk+1)*3 + dj+1 = i / W, x0 - 1 + i % W
  __shared__ int cell_off[9 * (kTileMaxX + 2)];
  for (int i = tid; i < nc; i += nthreads) {
    const int r = i / W;
    const int qx = x0 - 1 + (i - r * W);
    const int qy = cy + r % 3 - 1;
    const int qz = cz + r / 3 - 1;
    const bool in = qx >= 0 && qx < g.nx && qy >= 0 && qy < g.ny && qz >= 0
                    && qz < g.nz;
    cell_off[i] = in ? (qz * g.ny + qy) * g.nx + qx : -1;
  }

  if (__syncthreads_or(occ) && kend > 0) {  // uniform over the block
    float p[Body::NIN];
    if (occ) {
#pragma unroll
      for (int i = 0; i < Body::NIN; ++i) p[i] = f.in[i][ps];
    }
    // stage q rank kq into stage (kq & 1), one commit group
    auto stage_rank = [&](int kq) {
      float4* pos = stage + (kq & 1) * stage_f4;
      float* ex = reinterpret_cast<float*>(pos + nc);
      for (int i = tid; i < nc; i += nthreads) {
        const int off = cell_off[i];
        const bool in = off >= 0;
        const int64_t qi = kq * ld + (in ? off : 0);
        float* cell = reinterpret_cast<float*>(pos + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(cell + j, f.in[j] + qi, in);
#pragma unroll
        for (int j = 0; j < NE; ++j)
          cp_async4(ex + j * nc + i, f.in[Body::QLO + j] + qi, in);
      }
      cp_async_commit();
    };
    stage_rank(0);
    for (int kq = 0; kq < kend; ++kq) {
      if (kq + 1 < kend) {
        stage_rank(kq + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (occ) {
        const float4* pos = stage + (kq & 1) * stage_f4;
        const float* ex = reinterpret_cast<const float*>(pos + nc);
        float tot[Body::NOUT];
#pragma unroll
        for (int o = 0; o < Body::NOUT; ++o) tot[o] = 0.0f;
#pragma unroll 1
        for (int dk = 0; dk < 3; ++dk) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
            for (int di = 0; di < 3; ++di) {
              if (!SELF && di == 1 && dj == 1 && dk == 1 && kq == k) continue;
              const int s = (dk * 3 + dj) * W + tx + di;
              const float4 q = pos[s];
              if (!(q.x > 0.5f)) continue;
              float d[3];
              d[0] = p[1] - q.y;
              d[1] = p[2] - q.z;
              d[2] = p[3] - q.w;
              const float r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
              if (!(r2 <= g.h2)) continue;
              Body::pair(p, StagedQ{ex, nc, s, Body::QLO}, d, r2, prm, tot);
            }
          }
        }
#pragma unroll
        for (int o = 0; o < Body::NOUT; ++o) acc[o] += tot[o];
      }
      __syncthreads();  // every thread is done with this stage
    }
  }
  if (mine) {
#pragma unroll
    for (int o = 0; o < Body::NOUT; ++o) f.out[o][ps] = acc[o];
  }
}

// Launch pair_sweep3_tiled on the plan of ops/pair_sweeps.py::_tile_plan:
// tx x-cells per block and smem_bytes of dynamic shared memory for two
// stages; a plan the kernel cannot hold is refused.
template <class Body, bool SELF>
int launch3_tiled(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
                  const Layout3& g, const typename Body::Params& prm, int tx,
                  int smem_bytes, cudaStream_t stream) {
  constexpr int staged = 4 + Body::QHI - Body::QLO;  // floats per cell
  const int stage_f4 = smem_bytes / 32;  // one stage, in float4
  if (tx < 1 || tx > kTileMaxX || tx * g.cap > kTileThreads
      || stage_f4 * 16 < (tx + 2) * 9 * staged * 4)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = pair_sweep3_tiled<Body, SELF>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int ntiles = (g.nx + tx - 1) / tx;
  kernel<<<ntiles * g.ny * g.nz, dim3(tx, g.cap), smem_bytes, stream>>>(
      f, kmax, g, prm, stage_f4);
  return static_cast<int>(cudaGetLastError());
}

// The tiled 9-cell sweep of the 2-D density, the Pavelka continuity and
// fused momentum + entropy, the flagship momentum, the Hopkins pressure root
// and momentum, the Colagrossi packing's gradient, the terrain continuity and
// force (with fixed h and with per-particle h), the fused adiabatic entropy +
// force sweep, the ISPH CG matvec, divergence/viscous sweep and pressure
// gradient, the 2-D dam-break continuity and force and the Rayleigh-Benard
// continuity + conduction (pallas_pairs.py density_pass and
// adia_density_pass, pavelka_mass_pass, pavelka_momentum_entropy_pass,
// momentum_pass, pressure_pass, hopkins_momentum_pass, legacy_mass_pass,
// legacy_force_pass, iso_static_mass_pass, iso_static_force_pass,
// adia_entropy_force_pass, isph_matvec_prepared, isph_div_visc_pass,
// isph_grad_pass, dambreak_mass_pass, dambreak_force_pass,
// rb_mass_heat_pass; utils/packing.py find_gGamma):
// pair_sweep3_tiled's design in 2-D. One block is TX
// consecutive x-cells of one grid row cy times every p rank: thread
// (threadIdx.x, threadIdx.y) = (tx, k) owns slot (rank k, cell x0 + tx).
// Blocks run x-tiles fastest, then rows, so the three rows a tile reads stay
// in L2 for the tiles that share them. The q loop runs to kmax[blockIdx.x], the tile's own bound
// (ops/pair_sweeps.py::tile_kmax: the largest count among the (TX+2) x 3
// cells it stages; ranks are packed from 0, so every rank past it is empty in
// all of them). Each q rank of those cells is staged in shared memory once
// for all p ranks: occupancy, x0, x1 and plane 3 (h; 1/h in the density and
// the per-particle-h continuity, v0 in the terrain continuity and force with
// fixed h, the fused adiabatic sweep, the dam-break continuity and force,
// the Rayleigh-Benard sweep and the ISPH divergence, the iterate in the
// matvec, P in the ISPH gradient) as one
// float4 per cell (a candidate is one 16-byte shared load), the other q
// planes the body reads (Body::QMASK: none in the packing gradient, w in the
// density) as scalars; 4-byte cp.async, cells outside the grid zero-filled so
// that they read as unoccupied. Two staging schemes, one template each
// (EVERY_RANK):
//   false: two stages, rank kq+1 copied while rank kq is summed, a barrier
//          between a copy and its use and another before a stage is
//          overwritten (pair_sweep3_tiled's pipeline);
//   true:  every rank up to the bound copied in one go, one barrier (a
//          stage is small in 2-D: (TX+2) x 3 cells, 1.6 to 5.3 KB at TX 32
//          for 4 to 13 staged planes, so cap 8 ranks take 13 to 42 KB).
// The thread of an occupied p slot then takes its 9 cells per rank in
// pair_sweep's order (dj, then di), skips an empty q cell before any
// arithmetic on it, sums the pairs into tot and adds tot to acc. The self
// pair, (di, dj, kq) == (1, 1, k), is skipped unless SELF: the Hopkins
// pressure root and the density count it per self_pair (the paths'
// self_density; the adiabatic density always), the packing gradient always
// (its term is 0), every other sweep here never. With SELF it is summed in
// its place in the dj, di order of rank k, as pair_sweep<Body, true> sums
// it. So the same operations run in the same order, the ranks a tile skips
// would add exact zeros, and the outputs equal pair_sweep's (with the same
// SELF) bit for bit. A tile with no occupied p slot (or bound 0)
// writes its zeros and stages nothing; a ragged last tile masks its spare
// threads; block 0 writes the trash column. No TMA, for the reason
// pair_sweep3_tiled gives.
//
// At the flagship size (N = 978,463, grid 1792 x 144, cap 8: TX 32, 256
// threads, 8,064 blocks) pair_sweep reads the 8.3 MB planes from HBM once per
// p rank (its grid runs the p rank slowest, and 10-13 planes do not fit in
// the 50 MB L2), each candidate a chain of dependent gathers. Here each block
// reads each q plane's (TX+2) x 3 cells of a rank once. On an H100, against
// pair_sweep: Pavelka continuity 0.095 ms (0.26), fused 0.115 (0.29),
// momentum 0.085 (0.21), Hopkins split 0.113 (0.24) and total 0.096 (0.24),
// 15-21 % of the byte bound; every rank at once is 3-24 % faster than the
// pipeline, and half of a working block's warps (ranks 4-7 of a cap-8
// bucket holding ~4 particles a cell) only stage. The terrain force runs at
// cap 24 (N = 212,819, grid 256 x 72: TX 10, 240 threads, 1,872 blocks, a
// ragged last tile of 6), the matvec at cap 8 (N = 207,672, grid 896 x 72:
// TX 32, 2,016 blocks), each launch of the CG loop on the bound and plan
// prepared once per solve. The pressure root runs on the full-Hopkins state
// (cap 8: TX 32, 5 staged planes, 16,384 B for every rank at once), the
// terrain continuity on the terrain force's (cap 24: TX 10, 6 planes,
// 20,736 B): 0.055 ms (0.098 in pair_sweep) and 0.044 ms (0.081) of kernel
// time on an H100, 17.5 and 5.3 % of the byte bound. The flagship density
// takes the pressure root's plan (5 planes: the float4 of occupancy, x and
// 1/h, then w; 16,384 B), the packing gradient on the Pavelka state 4 planes
// (the float4 alone; 13,056 B), the adiabatic density of the corrected
// adiabatic flow (grid 640 x 48) cap 16: TX 16, 17,408 B. The small states
// of the dam break and Rayleigh-Benard: collapse_dry (N = 11,702, grid 128 x
// 64, cap 24, 6 % of slots filled: TX 10, 832 blocks of 240 threads, a
// ragged last tile of 8, 6 planes, 20,736 B) and the Rayleigh-Benard
// baseline (N = 53,621, grid 256 x 80, cap 16, 16 % filled: TX 16, 1,280
// blocks of 256 threads, 7 planes, 24,320 B): under one and about 1.2 waves
// of blocks, where pair_sweep's threads each waited on a chain of dependent
// gathers from L2; 0.018 ms (0.051 in pair_sweep) and 0.017 ms (0.043) of
// kernel time on an H100. The dam-break force on the collapse_dry state (6
// planes, the same plan) takes 0.019 ms (0.036), the ISPH divergence/viscous
// sweep on the matvec's state (5 planes, 16,384 B) 0.018 ms (0.030). The
// ISPH gradient stages the matvec's 4 planes (13,056 B) on its state: 0.015
// ms (0.021); the per-particle-h force 9 planes (29,440 B) or 10 with AV
// (32,640 B) on the isothermal static state (N = 47,915, grid 384 x 32, cap
// 8: TX 32, 384 blocks, 49 % of slots filled): 0.010 ms (0.019), 0.011 ms
// with AV (0.019).
template <class Body, bool SELF, bool EVERY_RANK>
__global__ void __launch_bounds__(kTileThreads)
pair_sweep_tiled(Planes<Body::NIN, Body::NOUT> f, const int* __restrict__ kmax,
                 Layout g, typename Body::Params prm, int stage_f4) {
  static_assert((Body::QMASK & 0xFu) == 0 && (Body::QMASK >> Body::NIN) == 0,
                "QMASK names planes 4..NIN-1 only");
  constexpr int NE = staged_count(Body::QMASK);  // scalar planes per cell
  extern __shared__ float4 stage[];
  const int TX = blockDim.x;
  const int W = TX + 2;  // staged cells per row
  const int nc = 3 * W;  // staged cells per rank
  const int tx = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * TX + tx;
  const int nthreads = TX * blockDim.y;
  const int ntiles = (g.nx + TX - 1) / TX;
  const int cy = blockIdx.x / ntiles;
  const int x0 = (blockIdx.x - cy * ntiles) * TX;
  const int C = g.nx * g.ny;
  const int64_t ld = C + 1;
  const bool mine = x0 + tx < g.nx;
  const int64_t ps = k * ld + (int64_t)cy * g.nx + x0 + tx;
  if (blockIdx.x == 0 && tx == 0) {
#pragma unroll
    for (int o = 0; o < Body::NOUT; ++o) f.out[o][k * ld + C] = 0.0f;
  }
  float acc[Body::NOUT];
#pragma unroll
  for (int o = 0; o < Body::NOUT; ++o) acc[o] = 0.0f;
  const bool occ = mine && f.in[0][ps] > 0.5f;
  const int kend = kmax[blockIdx.x];
  // each staged cell's offset in a plane (-1: outside the grid), the same
  // for every rank: dj + 1 = i / W, x0 - 1 + i % W
  __shared__ int cell_off[3 * (kTileMaxX + 2)];
  for (int i = tid; i < nc; i += nthreads) {
    const int r = i / W;
    const int qx = x0 - 1 + (i - r * W);
    const int qy = cy + r - 1;
    const bool in = qx >= 0 && qx < g.nx && qy >= 0 && qy < g.ny;
    cell_off[i] = in ? qy * g.nx + qx : -1;
  }

  if (__syncthreads_or(occ) && kend > 0) {  // uniform over the block
    float p[Body::NIN];
    if (occ) {
#pragma unroll
      for (int i = 0; i < Body::NIN; ++i) p[i] = f.in[i][ps];
    }
    // copy q ranks k0..k1-1 into their stages, one commit group
    auto stage_ranks = [&](int k0, int k1) {
      const int n = (k1 - k0) * nc;
      for (int i = tid; i < n; i += nthreads) {
        const int kq = k0 + i / nc;
        const int c = i - (kq - k0) * nc;
        const int off = cell_off[c];
        const bool in = off >= 0;
        const int64_t qi = kq * ld + (in ? off : 0);
        float4* pos = stage + (EVERY_RANK ? kq : kq & 1) * stage_f4;
        float* ex = reinterpret_cast<float*>(pos + nc);
        float* cell = reinterpret_cast<float*>(pos + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(cell + j, f.in[j] + qi, in);
#pragma unroll
        for (int j = 0; j < NE; ++j)
          cp_async4(ex + j * nc + c, f.in[staged_plane(Body::QMASK, j)] + qi,
                    in);
      }
      cp_async_commit();
    };
    // rank kq's 9 cells for this thread's p slot, in pair_sweep's order
    auto sum_rank = [&](int kq) {
      const float4* pos = stage + (EVERY_RANK ? kq : kq & 1) * stage_f4;
      const float* ex = reinterpret_cast<const float*>(pos + nc);
      float tot[Body::NOUT];
#pragma unroll
      for (int o = 0; o < Body::NOUT; ++o) tot[o] = 0.0f;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          if (!SELF && di == 1 && dj == 1 && kq == k) continue;
          const int s = dj * W + tx + di;
          const float4 q = pos[s];
          if (!(q.x > 0.5f)) continue;
          float d[2];
          d[0] = p[1] - q.y;
          d[1] = p[2] - q.z;
          const float r2 = d[0] * d[0] + d[1] * d[1];
          if (!(r2 <= g.h2)) continue;
          Body::pair(p, StagedQ2<Body::QMASK>{q, ex, nc, s}, d, r2, prm, tot);
        }
      }
#pragma unroll
      for (int o = 0; o < Body::NOUT; ++o) acc[o] += tot[o];
    };
    if constexpr (EVERY_RANK) {
      stage_ranks(0, kend);
      cp_async_wait<0>();
      __syncthreads();
      if (occ) {
        for (int kq = 0; kq < kend; ++kq) sum_rank(kq);
      }
    } else {
      stage_ranks(0, 1);
      for (int kq = 0; kq < kend; ++kq) {
        if (kq + 1 < kend) {
          stage_ranks(kq + 1, kq + 2);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (occ) sum_rank(kq);
        __syncthreads();  // every thread is done with this stage
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int o = 0; o < Body::NOUT; ++o) f.out[o][ps] = acc[o];
  }
}

// Launch pair_sweep_tiled (with the self pair if SELF) on the plan of
// ops/pair_sweeps.py::_tile_plan: tx x-cells per block and smem_bytes of
// dynamic shared memory. Room for every rank's stage (cap stages) takes the
// every-rank scheme, room for two the two-stage pipeline (at cap <= 2 the two
// are one); a plan the kernel cannot hold is refused.
template <class Body, bool SELF = false>
int launch_tiled(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
                 const Layout& g, const typename Body::Params& prm, int tx,
                 int smem_bytes, cudaStream_t stream) {
  constexpr int staged = 4 + staged_count(Body::QMASK);  // floats per cell
  const int stage = ((tx + 2) * 3 * staged * 4 + 15) / 16 * 16;  // bytes
  if (tx < 1 || tx > kTileMaxX || tx * g.cap > kTileThreads
      || smem_bytes < 2 * stage)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = smem_bytes >= g.cap * stage
                    ? pair_sweep_tiled<Body, SELF, true>
                    : pair_sweep_tiled<Body, SELF, false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int ntiles = (g.nx + tx - 1) / tx;
  kernel<<<ntiles * g.ny, dim3(tx, g.cap), smem_bytes, stream>>>(
      f, kmax, g, prm, stage / 16);
  return static_cast<int>(cudaGetLastError());
}

// The tiled 2-D exports: the tiled launch (TILED) on the plan (tx,
// smem_bytes), or pair_sweep (the "_direct" yardsticks, which take no plan),
// each with the self pair if SELF.
template <bool TILED, class Body, bool SELF = false>
int launch2(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
            const Layout& g, const typename Body::Params& prm, int tx,
            int smem_bytes, cudaStream_t s) {
  if constexpr (TILED) {
    return launch_tiled<Body, SELF>(f, kmax, g, prm, tx, smem_bytes, s);
  } else {
    return launch<Body, SELF>(f, kmax, g, prm, s);
  }
}

// The legacy force's exports: the input pointers in plane order (the FLUID
// gate, last, only with AV), the fast_math switch and, for the tiled launch
// (TILED), its plan (tx, smem_bytes).
template <bool TILED, bool ADAPTIVE_H, bool AV>
int legacy_force_launch(const float* const* in, const int* kmax, float* dv0,
                        float* dv1, const Layout& g, const LegacyParams& prm,
                        int fast_math, int tx, int smem_bytes,
                        cudaStream_t s) {
  using Exact = LegacyForce<2, ADAPTIVE_H, AV, false>;
  using Fast = LegacyForce<2, ADAPTIVE_H, AV, true>;
  Planes<Exact::NIN, Exact::NOUT> f{};
  for (int i = 0; i < Exact::NIN; ++i) f.in[i] = in[i];
  f.out[0] = dv0;
  f.out[1] = dv1;
  return fast_math ? launch2<TILED, Fast>(f, kmax, g, prm, tx, smem_bytes, s)
                   : launch2<TILED, Exact>(f, kmax, g, prm, tx, smem_bytes, s);
}

// the terrain force (fixed h, or per-particle h with ADAPTIVE_H) in the
// form av names
template <bool TILED, bool ADAPTIVE_H = false>
int legacy_force(const float* const* in, const int* kmax, float* dv0,
                 float* dv1, const Layout& g, const LegacyParams& prm, int av,
                 int fast_math, int tx, int smem_bytes, cudaStream_t s) {
  return av ? legacy_force_launch<TILED, ADAPTIVE_H, true>(
                  in, kmax, dv0, dv1, g, prm, fast_math, tx, smem_bytes, s)
            : legacy_force_launch<TILED, ADAPTIVE_H, false>(
                  in, kmax, dv0, dv1, g, prm, fast_math, tx, smem_bytes, s);
}

// The fused adiabatic sweep's exports: the fast_math switch and, for the
// tiled launch (TILED), its plan (tx, smem_bytes); one plan for both AV
// forms, which stage the same planes.
template <bool TILED, bool AV>
int adia_launch(const Planes<10, 3>& f, const int* kmax, const Layout& g,
                const LegacyParams& prm, int fast_math, int tx,
                int smem_bytes, cudaStream_t s) {
  return fast_math
      ? launch2<TILED, AdiaEntropyForce<2, AV, true>>(f, kmax, g, prm, tx,
                                                      smem_bytes, s)
      : launch2<TILED, AdiaEntropyForce<2, AV, false>>(f, kmax, g, prm, tx,
                                                       smem_bytes, s);
}

// the fused adiabatic sweep in the form av names
template <bool TILED>
int adia_entropy_force(const Planes<10, 3>& f, const int* kmax,
                       const Layout& g, const LegacyParams& prm, int av,
                       int fast_math, int tx, int smem_bytes, cudaStream_t s) {
  return av ? adia_launch<TILED, true>(f, kmax, g, prm, fast_math, tx,
                                       smem_bytes, s)
            : adia_launch<TILED, false>(f, kmax, g, prm, fast_math, tx,
                                        smem_bytes, s);
}

// The legacy continuity's exports (fixed h, or per-particle h with
// ADAPTIVE_H): the planes in order, and for the tiled launch (TILED) its
// plan (tx, smem_bytes).
template <bool TILED, bool ADAPTIVE_H>
int legacy_mass_launch(const Planes<LegacyMass<2, ADAPTIVE_H>::NIN, 1>& f,
                       const int* kmax, const Layout& g,
                       const LegacyParams& prm, int tx, int smem_bytes,
                       cudaStream_t s) {
  return launch2<TILED, LegacyMass<2, ADAPTIVE_H>>(f, kmax, g, prm, tx,
                                                    smem_bytes, s);
}

// the one-output weighted sums (pallas_pairs.py weighted_w_pass): the
// Hopkins pressure root (Pressure) and the 2-D density (Density), with the
// self pair if self_pair
template <bool TILED, class Body>
int weighted_w(const Planes<Body::NIN, Body::NOUT>& f, const int* kmax,
               const Layout& g, float cw, int self_pair, int tx, int smem_bytes,
               cudaStream_t s) {
  return self_pair
      ? launch2<TILED, Body, true>(f, kmax, g, {cw}, tx, smem_bytes, s)
      : launch2<TILED, Body, false>(f, kmax, g, {cw}, tx, smem_bytes, s);
}

template <bool TILED>
int pavelka_mass(const Planes<9, 1>& f, const int* kmax, const Layout& g,
                 float dw, float two_nu, int fixed_diffusion, int fast_math,
                 int tx, int smem_bytes, cudaStream_t s) {
  if (fixed_diffusion) {
    return fast_math
        ? launch2<TILED, PavelkaMass<true, true>>(f, kmax, g, {dw, two_nu}, tx,
                                                  smem_bytes, s)
        : launch2<TILED, PavelkaMass<false, true>>(f, kmax, g, {dw, two_nu},
                                                   tx, smem_bytes, s);
  }
  return fast_math
      ? launch2<TILED, PavelkaMass<true, false>>(f, kmax, g, {dw, two_nu}, tx,
                                                 smem_bytes, s)
      : launch2<TILED, PavelkaMass<false, false>>(f, kmax, g, {dw, two_nu}, tx,
                                                  smem_bytes, s);
}

template <bool TILED>
int pavelka_momentum_entropy(const Planes<12, 3>& f, const int* kmax,
                             const Layout& g, float dw, float mu, float dt,
                             int fast_math, int tx, int smem_bytes,
                             cudaStream_t s) {
  return fast_math
      ? launch2<TILED, PavelkaMomentumEntropy<true>>(f, kmax, g, {dw, mu, dt},
                                                     tx, smem_bytes, s)
      : launch2<TILED, PavelkaMomentumEntropy<false>>(f, kmax, g, {dw, mu, dt},
                                                      tx, smem_bytes, s);
}

template <bool TILED>
int momentum(const Planes<10, 2>& f, const int* kmax, const Layout& g,
             float dw, float eps, float nalpha, float beta, int fast_math,
             int tx, int smem_bytes, cudaStream_t s) {
  return fast_math
      ? launch2<TILED, Momentum<true>>(f, kmax, g, {dw, eps, nalpha, beta}, tx,
                                       smem_bytes, s)
      : launch2<TILED, Momentum<false>>(f, kmax, g, {dw, eps, nalpha, beta},
                                        tx, smem_bytes, s);
}

// in: the 13 planes in order, abg and pbe (the last two) read only with
// background_split (null otherwise)
template <bool TILED>
int hopkins_momentum(const float* const* in, float* dv0, float* dv1,
                     const int* kmax, const Layout& g, float dw, float eps,
                     float nalpha, float beta, int background_split,
                     int fast_math, int tx, int smem_bytes, cudaStream_t s) {
  if (background_split) {
    Planes<13, 2> f{{}, {dv0, dv1}};
    for (int i = 0; i < 13; ++i) f.in[i] = in[i];
    return fast_math
        ? launch2<TILED, Hopkins<true, true>>(f, kmax, g,
                                              {dw, eps, nalpha, beta}, tx,
                                              smem_bytes, s)
        : launch2<TILED, Hopkins<false, true>>(f, kmax, g,
                                               {dw, eps, nalpha, beta}, tx,
                                               smem_bytes, s);
  }
  Planes<11, 2> f{{}, {dv0, dv1}};
  for (int i = 0; i < 11; ++i) f.in[i] = in[i];
  return fast_math
      ? launch2<TILED, Hopkins<true, false>>(f, kmax, g,
                                             {dw, eps, nalpha, beta}, tx,
                                             smem_bytes, s)
      : launch2<TILED, Hopkins<false, false>>(f, kmax, g,
                                              {dw, eps, nalpha, beta}, tx,
                                              smem_bytes, s);
}

}  // namespace

extern "C" {

const char* pair_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Inputs and outputs are [cap, nx*ny+1] f32 planes. The 2-D density
// launches pair_sweep_tiled, with the self pair if self_pair, on the plan
// (tx, smem_bytes) the wrapper passes, kmax int32 [ny*ntiles] (one bound per
// x-tile); its "_direct" export launches pair_sweep (kmax int32 [ny] per grid
// row), the design the tiled one replaced: a yardstick, on no path.
int density_sweep(const float* occ, const float* x0, const float* x1,
                  const float* hinv, const float* w, const int* kmax,
                  float* rho, int cap, int nx, int ny, float h2,
                  int self_pair, float cw, int tx, int smem_bytes,
                  void* stream) {
  return weighted_w<true, Density>({{occ, x0, x1, hinv, w}, {rho}}, kmax,
                                   {cap, nx, ny, h2}, cw, self_pair, tx,
                                   smem_bytes,
                                   static_cast<cudaStream_t>(stream));
}

int density_sweep_direct(const float* occ, const float* x0, const float* x1,
                         const float* hinv, const float* w, const int* kmax,
                         float* rho, int cap, int nx, int ny, float h2,
                         int self_pair, float cw, void* stream) {
  return weighted_w<false, Density>({{occ, x0, x1, hinv, w}, {rho}}, kmax,
                                    {cap, nx, ny, h2}, cw, self_pair, 0, 0,
                                    static_cast<cudaStream_t>(stream));
}

// The flagship momentum, the Hopkins momentum and the Pavelka sweeps launch
// pair_sweep_tiled on the plan (tx, smem_bytes) the wrapper passes, with kmax
// int32 [ny*ntiles] (one bound per x-tile, ntiles = ceil(nx / tx)); their
// "_direct" exports launch pair_sweep (one thread per slot, q read from the
// planes, kmax int32 [ny] per grid row), the design the tiled one replaced: a
// yardstick, on no path.
int momentum_sweep(const float* occ, const float* x0, const float* x1,
                   const float* h, const float* m, const float* v0,
                   const float* v1, const float* rho, const float* aterm,
                   const float* cs, const int* kmax, float* dv0, float* dv1,
                   int cap, int nx, int ny, float h2, float dw, float eps,
                   float nalpha, float beta, int fast_math, int tx,
                   int smem_bytes, void* stream) {
  return momentum<true>({{occ, x0, x1, h, m, v0, v1, rho, aterm, cs},
                         {dv0, dv1}},
                        kmax, {cap, nx, ny, h2}, dw, eps, nalpha, beta,
                        fast_math, tx, smem_bytes,
                        static_cast<cudaStream_t>(stream));
}

int momentum_sweep_direct(const float* occ, const float* x0, const float* x1,
                          const float* h, const float* m, const float* v0,
                          const float* v1, const float* rho,
                          const float* aterm, const float* cs, const int* kmax,
                          float* dv0, float* dv1, int cap, int nx, int ny,
                          float h2, float dw, float eps, float nalpha,
                          float beta, int fast_math, void* stream) {
  return momentum<false>({{occ, x0, x1, h, m, v0, v1, rho, aterm, cs},
                          {dv0, dv1}},
                         kmax, {cap, nx, ny, h2}, dw, eps, nalpha, beta,
                         fast_math, 0, 0, static_cast<cudaStream_t>(stream));
}

// The pressure root launches pair_sweep_tiled, with the self pair if
// self_pair, on the plan (tx, smem_bytes) the wrapper passes, one bound per
// x-tile; its "_direct" export launches pair_sweep (kmax int32 [ny] per grid
// row), the design the tiled one replaced: a yardstick, on no path.
int pressure_sweep(const float* occ, const float* x0, const float* x1,
                   const float* h, const float* w, const int* kmax,
                   float* proot, int cap, int nx, int ny, float h2,
                   int self_pair, float cw, int tx, int smem_bytes,
                   void* stream) {
  return weighted_w<true, Pressure>({{occ, x0, x1, h, w}, {proot}}, kmax,
                                    {cap, nx, ny, h2}, cw, self_pair, tx,
                                    smem_bytes,
                                    static_cast<cudaStream_t>(stream));
}

int pressure_sweep_direct(const float* occ, const float* x0, const float* x1,
                          const float* h, const float* w, const int* kmax,
                          float* proot, int cap, int nx, int ny, float h2,
                          int self_pair, float cw, void* stream) {
  return weighted_w<false, Pressure>({{occ, x0, x1, h, w}, {proot}}, kmax,
                                     {cap, nx, ny, h2}, cw, self_pair, 0, 0,
                                     static_cast<cudaStream_t>(stream));
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
                           int background_split, int fast_math, int tx,
                           int smem_bytes, void* stream) {
  const float* in[13] = {occ, x0, x1, h, m, v0, v1, rho, cs, ag, pe, abg, pbe};
  return hopkins_momentum<true>(in, dv0, dv1, kmax, {cap, nx, ny, h2}, dw, eps,
                                nalpha, beta, background_split, fast_math, tx,
                                smem_bytes, static_cast<cudaStream_t>(stream));
}

int hopkins_momentum_sweep_direct(
    const float* occ, const float* x0, const float* x1, const float* h,
    const float* m, const float* v0, const float* v1, const float* rho,
    const float* cs, const float* ag, const float* pe, const float* abg,
    const float* pbe, const int* kmax, float* dv0, float* dv1, int cap, int nx,
    int ny, float h2, float dw, float eps, float nalpha, float beta,
    int background_split, int fast_math, void* stream) {
  const float* in[13] = {occ, x0, x1, h, m, v0, v1, rho, cs, ag, pe, abg, pbe};
  return hopkins_momentum<false>(in, dv0, dv1, kmax, {cap, nx, ny, h2}, dw,
                                 eps, nalpha, beta, background_split,
                                 fast_math, 0, 0,
                                 static_cast<cudaStream_t>(stream));
}

int pavelka_mass_sweep(const float* occ, const float* x0, const float* x1,
                       const float* h, const float* v0, const float* v1,
                       const float* rho, const float* wq, const float* fluid,
                       const int* kmax, float* drho, int cap, int nx, int ny,
                       float h2, float dw, float two_nu, int fixed_diffusion,
                       int fast_math, int tx, int smem_bytes, void* stream) {
  return pavelka_mass<true>({{occ, x0, x1, h, v0, v1, rho, wq, fluid}, {drho}},
                            kmax, {cap, nx, ny, h2}, dw, two_nu,
                            fixed_diffusion, fast_math, tx, smem_bytes,
                            static_cast<cudaStream_t>(stream));
}

int pavelka_mass_sweep_direct(const float* occ, const float* x0,
                              const float* x1, const float* h, const float* v0,
                              const float* v1, const float* rho,
                              const float* wq, const float* fluid,
                              const int* kmax, float* drho, int cap, int nx,
                              int ny, float h2, float dw, float two_nu,
                              int fixed_diffusion, int fast_math,
                              void* stream) {
  return pavelka_mass<false>({{occ, x0, x1, h, v0, v1, rho, wq, fluid}, {drho}},
                             kmax, {cap, nx, ny, h2}, dw, two_nu,
                             fixed_diffusion, fast_math, 0, 0,
                             static_cast<cudaStream_t>(stream));
}

int pavelka_momentum_entropy_sweep(
    const float* occ, const float* x0, const float* x1, const float* h,
    const float* m, const float* v0, const float* v1, const float* rho,
    const float* wq, const float* pterm, const float* temp,
    const float* fluid, const int* kmax, float* dv0, float* dv1, float* ds,
    int cap, int nx, int ny, float h2, float dw, float mu, float dt,
    int fast_math, int tx, int smem_bytes, void* stream) {
  return pavelka_momentum_entropy<true>(
      {{occ, x0, x1, h, m, v0, v1, rho, wq, pterm, temp, fluid},
       {dv0, dv1, ds}},
      kmax, {cap, nx, ny, h2}, dw, mu, dt, fast_math, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int pavelka_momentum_entropy_sweep_direct(
    const float* occ, const float* x0, const float* x1, const float* h,
    const float* m, const float* v0, const float* v1, const float* rho,
    const float* wq, const float* pterm, const float* temp,
    const float* fluid, const int* kmax, float* dv0, float* dv1, float* ds,
    int cap, int nx, int ny, float h2, float dw, float mu, float dt,
    int fast_math, void* stream) {
  return pavelka_momentum_entropy<false>(
      {{occ, x0, x1, h, m, v0, v1, rho, wq, pterm, temp, fluid},
       {dv0, dv1, ds}},
      kmax, {cap, nx, ny, h2}, dw, mu, dt, fast_math, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// The packing gradient (with the self pair) launches pair_sweep_tiled on the
// plan (tx, smem_bytes) the wrapper passes, one bound per x-tile; its
// "_direct" export launches pair_sweep (kmax int32 [ny] per grid row), the
// design the tiled one replaced: a yardstick, on no path.
int gamma_grad_sweep(const float* occ, const float* x0, const float* x1,
                     const float* h, const int* kmax, float* g0, float* g1,
                     int cap, int nx, int ny, float h2, float coef, int tx,
                     int smem_bytes, void* stream) {
  return launch2<true, GammaGrad, true>({{occ, x0, x1, h}, {g0, g1}}, kmax,
                                        {cap, nx, ny, h2}, {coef}, tx,
                                        smem_bytes,
                                        static_cast<cudaStream_t>(stream));
}

int gamma_grad_sweep_direct(const float* occ, const float* x0,
                            const float* x1, const float* h, const int* kmax,
                            float* g0, float* g1, int cap, int nx, int ny,
                            float h2, float coef, void* stream) {
  return launch2<false, GammaGrad, true>({{occ, x0, x1, h}, {g0, g1}}, kmax,
                                         {cap, nx, ny, h2}, {coef}, 0, 0,
                                         static_cast<cudaStream_t>(stream));
}

// dam-break sweeps, 2-D: planes [cap, nx*ny+1]. The continuity and the
// force launch pair_sweep_tiled on the plan (tx, smem_bytes) the wrapper
// passes, kmax int32 [ny*ntiles] (one bound per x-tile); their "_direct"
// exports launch pair_sweep (kmax int32 [ny] per grid row), the design the
// tiled one replaced: yardsticks, on no path.
int dambreak_mass_sweep(const float* occ, const float* x0, const float* x1,
                        const float* v0, const float* v1, const float* rho,
                        const int* kmax, float* drho, int cap, int nx, int ny,
                        float h2, float kc, float hinv, float two_nu, int tx,
                        int smem_bytes, void* stream) {
  return launch_tiled<DamMass<2>>({{occ, x0, x1, v0, v1, rho}, {drho}}, kmax,
                                  {cap, nx, ny, h2}, {kc, hinv, two_nu}, tx,
                                  smem_bytes,
                                  static_cast<cudaStream_t>(stream));
}

int dambreak_mass_sweep_direct(const float* occ, const float* x0,
                               const float* x1, const float* v0,
                               const float* v1, const float* rho,
                               const int* kmax, float* drho, int cap, int nx,
                               int ny, float h2, float kc, float hinv,
                               float two_nu, void* stream) {
  return launch<DamMass<2>, false>({{occ, x0, x1, v0, v1, rho}, {drho}}, kmax,
                                   {cap, nx, ny, h2}, {kc, hinv, two_nu},
                                   static_cast<cudaStream_t>(stream));
}

int dambreak_force_sweep(const float* occ, const float* x0, const float* x1,
                         const float* v0, const float* v1, const float* pterm,
                         const float* fluid, const int* kmax, float* dv0,
                         float* dv1, int cap, int nx, int ny, float h2,
                         float kc, float hinv, float visc_c, int tx,
                         int smem_bytes, void* stream) {
  return launch_tiled<DamForce<2>>(
      {{occ, x0, x1, v0, v1, pterm, fluid}, {dv0, dv1}}, kmax,
      {cap, nx, ny, h2}, {kc, hinv, visc_c}, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int dambreak_force_sweep_direct(const float* occ, const float* x0,
                                const float* x1, const float* v0,
                                const float* v1, const float* pterm,
                                const float* fluid, const int* kmax,
                                float* dv0, float* dv1, int cap, int nx,
                                int ny, float h2, float kc, float hinv,
                                float visc_c, void* stream) {
  return launch<DamForce<2>, false>(
      {{occ, x0, x1, v0, v1, pterm, fluid}, {dv0, dv1}}, kmax,
      {cap, nx, ny, h2}, {kc, hinv, visc_c},
      static_cast<cudaStream_t>(stream));
}

// legacy (terrain) sweeps, 2-D: planes [cap, nx*ny+1]. The fixed-h
// continuity launches pair_sweep_tiled on the plan (tx, smem_bytes) the
// wrapper passes, one bound per x-tile; its "_direct" export launches
// pair_sweep (kmax int32 [ny] per grid row), the design the tiled one
// replaced: a yardstick, on no path. So do the per-particle-h continuity
// and its "_direct" export.
int legacy_mass_sweep(const float* occ, const float* x0, const float* x1,
                      const float* v0, const float* v1, const float* m,
                      const int* kmax, float* drho, int cap, int nx, int ny,
                      float h2, float kc, float hinv, int tx, int smem_bytes,
                      void* stream) {
  return legacy_mass_launch<true, false>(
      {{occ, x0, x1, v0, v1, m}, {drho}}, kmax, {cap, nx, ny, h2},
      {kc, hinv, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int legacy_mass_sweep_direct(const float* occ, const float* x0,
                             const float* x1, const float* v0,
                             const float* v1, const float* m, const int* kmax,
                             float* drho, int cap, int nx, int ny, float h2,
                             float kc, float hinv, void* stream) {
  return legacy_mass_launch<false, false>(
      {{occ, x0, x1, v0, v1, m}, {drho}}, kmax, {cap, nx, ny, h2},
      {kc, hinv, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, 0, 0,
      static_cast<cudaStream_t>(stream));
}

int iso_static_mass_sweep(const float* occ, const float* x0, const float* x1,
                          const float* hinv, const float* v0, const float* v1,
                          const float* wq, const int* kmax, float* out,
                          int cap, int nx, int ny, float h2, float dw, int tx,
                          int smem_bytes, void* stream) {
  return legacy_mass_launch<true, true>(
      {{occ, x0, x1, hinv, v0, v1, wq}, {out}}, kmax, {cap, nx, ny, h2},
      {dw, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int iso_static_mass_sweep_direct(const float* occ, const float* x0,
                                 const float* x1, const float* hinv,
                                 const float* v0, const float* v1,
                                 const float* wq, const int* kmax, float* out,
                                 int cap, int nx, int ny, float h2, float dw,
                                 void* stream) {
  return legacy_mass_launch<false, true>(
      {{occ, x0, x1, hinv, v0, v1, wq}, {out}}, kmax, {cap, nx, ny, h2},
      {dw, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// fluid is read only with av (it may be null otherwise). The terrain force
// launches pair_sweep_tiled on the plan (tx, smem_bytes) the wrapper passes,
// with kmax int32 [ny*ntiles] (one bound per x-tile); the "_direct" export
// launches pair_sweep (kmax int32 [ny] per grid row), the design the tiled
// one replaced: a yardstick, on no path.
int legacy_force_sweep(const float* occ, const float* x0, const float* x1,
                       const float* v0, const float* v1, const float* m,
                       const float* pterm, const float* rinv,
                       const float* fluid, const int* kmax, float* dv0,
                       float* dv1, int cap, int nx, int ny, float h2, float kc,
                       float hinv, float eps_h2, float mu8, float nac,
                       float two_av, float h0, int av, int fast_math, int tx,
                       int smem_bytes, void* stream) {
  const float* in[] = {occ, x0, x1, v0, v1, m, pterm, rinv, fluid};
  return legacy_force<true>(in, kmax, dv0, dv1, {cap, nx, ny, h2},
                            {kc, hinv, eps_h2, mu8, 0.0f, nac, two_av, h0}, av,
                            fast_math, tx, smem_bytes,
                            static_cast<cudaStream_t>(stream));
}

int legacy_force_sweep_direct(const float* occ, const float* x0,
                              const float* x1, const float* v0,
                              const float* v1, const float* m,
                              const float* pterm, const float* rinv,
                              const float* fluid, const int* kmax, float* dv0,
                              float* dv1, int cap, int nx, int ny, float h2,
                              float kc, float hinv, float eps_h2, float mu8,
                              float nac, float two_av, float h0, int av,
                              int fast_math, void* stream) {
  const float* in[] = {occ, x0, x1, v0, v1, m, pterm, rinv, fluid};
  return legacy_force<false>(in, kmax, dv0, dv1, {cap, nx, ny, h2},
                             {kc, hinv, eps_h2, mu8, 0.0f, nac, two_av, h0},
                             av, fast_math, 0, 0,
                             static_cast<cudaStream_t>(stream));
}

// The per-particle-h force (fluid read only with av, null otherwise)
// launches pair_sweep_tiled on the plan (tx, smem_bytes) the wrapper passes,
// with kmax int32 [ny*ntiles] (one bound per x-tile); the "_direct" export
// launches pair_sweep (kmax int32 [ny] per grid row), the design the tiled
// one replaced: a yardstick, on no path.
int iso_static_force_sweep(const float* occ, const float* x0, const float* x1,
                           const float* h, const float* v0, const float* v1,
                           const float* m, const float* pterm,
                           const float* rinv, const float* fluid,
                           const int* kmax, float* dv0, float* dv1, int cap,
                           int nx, int ny, float h2, float dw, float mu8,
                           float nac, float two_av, int av, int fast_math,
                           int tx, int smem_bytes, void* stream) {
  const float* in[] = {occ, x0, x1, h, v0, v1, m, pterm, rinv, fluid};
  return legacy_force<true, true>(
      in, kmax, dv0, dv1, {cap, nx, ny, h2},
      {dw, 0.0f, 0.0f, mu8, 0.0f, nac, two_av, 0.0f}, av, fast_math, tx,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

int iso_static_force_sweep_direct(
    const float* occ, const float* x0, const float* x1, const float* h,
    const float* v0, const float* v1, const float* m, const float* pterm,
    const float* rinv, const float* fluid, const int* kmax, float* dv0,
    float* dv1, int cap, int nx, int ny, float h2, float dw, float mu8,
    float nac, float two_av, int av, int fast_math, void* stream) {
  const float* in[] = {occ, x0, x1, h, v0, v1, m, pterm, rinv, fluid};
  return legacy_force<false, true>(
      in, kmax, dv0, dv1, {cap, nx, ny, h2},
      {dw, 0.0f, 0.0f, mu8, 0.0f, nac, two_av, 0.0f}, av, fast_math, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// The fused adiabatic entropy + force sweep launches pair_sweep_tiled on the
// plan (tx, smem_bytes) the wrapper passes, kmax int32 [ny*ntiles] (one bound
// per x-tile); its "_direct" export launches pair_sweep (kmax int32 [ny] per
// grid row), the design the tiled one replaced: a yardstick, on no path.
int adia_entropy_force_sweep(const float* occ, const float* x0,
                             const float* x1, const float* v0, const float* v1,
                             const float* m, const float* pterm,
                             const float* rinv, const float* fluid,
                             const float* mti, const int* kmax, float* ds,
                             float* dv0, float* dv1, int cap, int nx, int ny,
                             float h2, float kc, float hinv, float eps_h2,
                             float mu8, float nmu4dt, float nac, float two_av,
                             float h0, int av, int fast_math, int tx,
                             int smem_bytes, void* stream) {
  return adia_entropy_force<true>(
      {{occ, x0, x1, v0, v1, m, pterm, rinv, fluid, mti}, {ds, dv0, dv1}},
      kmax, {cap, nx, ny, h2},
      {kc, hinv, eps_h2, mu8, nmu4dt, nac, two_av, h0}, av, fast_math, tx,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

int adia_entropy_force_sweep_direct(
    const float* occ, const float* x0, const float* x1, const float* v0,
    const float* v1, const float* m, const float* pterm, const float* rinv,
    const float* fluid, const float* mti, const int* kmax, float* ds,
    float* dv0, float* dv1, int cap, int nx, int ny, float h2, float kc,
    float hinv, float eps_h2, float mu8, float nmu4dt, float nac,
    float two_av, float h0, int av, int fast_math, void* stream) {
  return adia_entropy_force<false>(
      {{occ, x0, x1, v0, v1, m, pterm, rinv, fluid, mti}, {ds, dv0, dv1}},
      kmax, {cap, nx, ny, h2},
      {kc, hinv, eps_h2, mu8, nmu4dt, nac, two_av, h0}, av, fast_math, 0, 0,
      static_cast<cudaStream_t>(stream));
}


// ISPH and Rayleigh-Benard sweeps, 2-D: planes [cap, nx*ny+1]. The
// divergence/viscous sweep launches pair_sweep_tiled on the plan (tx,
// smem_bytes) the wrapper passes, kmax int32 [ny*ntiles] (one bound per
// x-tile); its "_direct" export launches pair_sweep (kmax int32 [ny] per
// grid row), the design the tiled one replaced: a yardstick, on no path.
int isph_div_visc_sweep(const float* occ, const float* x0, const float* x1,
                        const float* v0, const float* v1, const int* kmax,
                        float* s_divv, float* s_l, float* s_lam, float* s_dv0,
                        float* s_dv1, int cap, int nx, int ny, float h2,
                        float hinv, float kw, int tx, int smem_bytes,
                        void* stream) {
  return launch_tiled<IsphDivVisc>(
      {{occ, x0, x1, v0, v1}, {s_divv, s_l, s_lam, s_dv0, s_dv1}}, kmax,
      {cap, nx, ny, h2}, {hinv, kw}, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int isph_div_visc_sweep_direct(const float* occ, const float* x0,
                               const float* x1, const float* v0,
                               const float* v1, const int* kmax, float* s_divv,
                               float* s_l, float* s_lam, float* s_dv0,
                               float* s_dv1, int cap, int nx, int ny, float h2,
                               float hinv, float kw, void* stream) {
  return launch<IsphDivVisc, false>(
      {{occ, x0, x1, v0, v1}, {s_divv, s_l, s_lam, s_dv0, s_dv1}}, kmax,
      {cap, nx, ny, h2}, {hinv, kw}, static_cast<cudaStream_t>(stream));
}

// The CG matvec launches pair_sweep_tiled on the plan (tx, smem_bytes) the
// prepared wrapper passes, with kmax int32 [ny*ntiles] (one bound per
// x-tile); the "_direct" export launches pair_sweep (kmax int32 [ny] per grid
// row), the design the tiled one replaced: a yardstick, on no path.
int isph_matvec_sweep(const float* occ, const float* x0, const float* x1,
                      const float* v, const int* kmax, float* out, int cap,
                      int nx, int ny, float h2, float hinv, float kw, int tx,
                      int smem_bytes, void* stream) {
  return launch_tiled<IsphMatvec>({{occ, x0, x1, v}, {out}}, kmax,
                                  {cap, nx, ny, h2}, {hinv, kw}, tx, smem_bytes,
                                  static_cast<cudaStream_t>(stream));
}

int isph_matvec_sweep_direct(const float* occ, const float* x0,
                             const float* x1, const float* v, const int* kmax,
                             float* out, int cap, int nx, int ny, float h2,
                             float hinv, float kw, void* stream) {
  return launch<IsphMatvec, false>({{occ, x0, x1, v}, {out}}, kmax,
                                   {cap, nx, ny, h2}, {hinv, kw},
                                   static_cast<cudaStream_t>(stream));
}

// The pressure gradient launches pair_sweep_tiled on the plan (tx,
// smem_bytes) the wrapper passes, kmax int32 [ny*ntiles] (one bound per
// x-tile); its "_direct" export launches pair_sweep (kmax int32 [ny] per grid
// row), the design the tiled one replaced: a yardstick, on no path.
int isph_grad_sweep(const float* occ, const float* x0, const float* x1,
                    const float* pres, const int* kmax, float* g0, float* g1,
                    int cap, int nx, int ny, float h2, float hinv, float kw,
                    int tx, int smem_bytes, void* stream) {
  return launch_tiled<IsphGrad>({{occ, x0, x1, pres}, {g0, g1}}, kmax,
                                {cap, nx, ny, h2}, {hinv, kw}, tx, smem_bytes,
                                static_cast<cudaStream_t>(stream));
}

int isph_grad_sweep_direct(const float* occ, const float* x0, const float* x1,
                           const float* pres, const int* kmax, float* g0,
                           float* g1, int cap, int nx, int ny, float h2,
                           float hinv, float kw, void* stream) {
  return launch<IsphGrad, false>({{occ, x0, x1, pres}, {g0, g1}}, kmax,
                                 {cap, nx, ny, h2}, {hinv, kw},
                                 static_cast<cudaStream_t>(stream));
}

// The Rayleigh-Benard continuity + conduction launches pair_sweep_tiled on
// the plan (tx, smem_bytes) the wrapper passes, kmax int32 [ny*ntiles] (one
// bound per x-tile); its "_direct" export launches pair_sweep (kmax int32
// [ny] per grid row), the design the tiled one replaced: a yardstick, on no
// path.
int rb_mass_heat_sweep(const float* occ, const float* x0, const float* x1,
                       const float* v0, const float* v1, const float* temp,
                       const float* rinv, const int* kmax, float* drho,
                       float* dtemp, int cap, int nx, int ny, float h2,
                       float kc, float hinv, float twokap, int tx,
                       int smem_bytes, void* stream) {
  return launch_tiled<RbMassHeat>(
      {{occ, x0, x1, v0, v1, temp, rinv}, {drho, dtemp}}, kmax,
      {cap, nx, ny, h2}, {kc, hinv, twokap}, tx, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int rb_mass_heat_sweep_direct(const float* occ, const float* x0,
                              const float* x1, const float* v0,
                              const float* v1, const float* temp,
                              const float* rinv, const int* kmax, float* drho,
                              float* dtemp, int cap, int nx, int ny, float h2,
                              float kc, float hinv, float twokap,
                              void* stream) {
  return launch<RbMassHeat, false>(
      {{occ, x0, x1, v0, v1, temp, rinv}, {drho, dtemp}}, kmax,
      {cap, nx, ny, h2}, {kc, hinv, twokap},
      static_cast<cudaStream_t>(stream));
}

// 3-D sweeps: planes [cap, nx*ny*nz+1]. The density, momentum and
// dam-break sweeps launch pair_sweep3_tiled on the plan (tx, smem_bytes) the
// wrapper passes, with kmax int32 [nz*ny*ntiles] (one bound per x-tile,
// ntiles = ceil(nx / tx)); their "_direct" exports launch pair_sweep3 (one
// thread per slot, q read from the planes, kmax int32 [nz*ny] per grid
// row), the design the tiled one replaced: a yardstick, on no path.
int density_sweep_3d(const float* occ, const float* x0, const float* x1,
                     const float* x2, const float* hinv, const float* w,
                     const int* kmax, float* rho, int cap, int nx, int ny,
                     int nz, float h2, int self_pair, float cw, int tx,
                     int smem_bytes, void* stream) {
  Planes<Density3::NIN, Density3::NOUT> f{{occ, x0, x1, x2, hinv, w}, {rho}};
  const Layout3 g{cap, nx, ny, nz, h2};
  const Density3::Params prm{cw};
  auto s = static_cast<cudaStream_t>(stream);
  return self_pair
      ? launch3_tiled<Density3, true>(f, kmax, g, prm, tx, smem_bytes, s)
      : launch3_tiled<Density3, false>(f, kmax, g, prm, tx, smem_bytes, s);
}

int density_sweep_3d_direct(const float* occ, const float* x0,
                            const float* x1, const float* x2,
                            const float* hinv, const float* w, const int* kmax,
                            float* rho, int cap, int nx, int ny, int nz,
                            float h2, int self_pair, float cw, void* stream) {
  Planes<Density3::NIN, Density3::NOUT> f{{occ, x0, x1, x2, hinv, w}, {rho}};
  const Layout3 g{cap, nx, ny, nz, h2};
  const Density3::Params prm{cw};
  auto s = static_cast<cudaStream_t>(stream);
  return self_pair ? launch3<Density3, true>(f, kmax, g, prm, s)
                   : launch3<Density3, false>(f, kmax, g, prm, s);
}

int momentum_sweep_3d(const float* occ, const float* x0, const float* x1,
                      const float* x2, const float* h, const float* m,
                      const float* v0, const float* v1, const float* v2,
                      const float* rho, const float* aterm, const float* cs,
                      const int* kmax, float* dv0, float* dv1, float* dv2,
                      int cap, int nx, int ny, int nz, float h2, float dw,
                      float eps, float nalpha, float beta, int fast_math,
                      int tx, int smem_bytes, void* stream) {
  Planes<12, 3> f{{occ, x0, x1, x2, h, m, v0, v1, v2, rho, aterm, cs},
                  {dv0, dv1, dv2}};
  const Layout3 g{cap, nx, ny, nz, h2};
  auto s = static_cast<cudaStream_t>(stream);
  return fast_math
      ? launch3_tiled<Momentum3<true>, false>(f, kmax, g, {dw, eps, nalpha, beta},
                                              tx, smem_bytes, s)
      : launch3_tiled<Momentum3<false>, false>(f, kmax, g, {dw, eps, nalpha, beta},
                                               tx, smem_bytes, s);
}

int momentum_sweep_3d_direct(const float* occ, const float* x0,
                             const float* x1, const float* x2, const float* h,
                             const float* m, const float* v0, const float* v1,
                             const float* v2, const float* rho,
                             const float* aterm, const float* cs,
                             const int* kmax, float* dv0, float* dv1,
                             float* dv2, int cap, int nx, int ny, int nz,
                             float h2, float dw, float eps, float nalpha,
                             float beta, int fast_math, void* stream) {
  Planes<12, 3> f{{occ, x0, x1, x2, h, m, v0, v1, v2, rho, aterm, cs},
                  {dv0, dv1, dv2}};
  const Layout3 g{cap, nx, ny, nz, h2};
  auto s = static_cast<cudaStream_t>(stream);
  return fast_math
      ? launch3<Momentum3<true>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s)
      : launch3<Momentum3<false>, false>(f, kmax, g, {dw, eps, nalpha, beta}, s);
}

int dambreak_mass_sweep_3d(const float* occ, const float* x0, const float* x1,
                           const float* x2, const float* v0, const float* v1,
                           const float* v2, const float* rho, const int* kmax,
                           float* drho, int cap, int nx, int ny, int nz,
                           float h2, float kc, float hinv, float two_nu,
                           int tx, int smem_bytes, void* stream) {
  Planes<8, 1> f{{occ, x0, x1, x2, v0, v1, v2, rho}, {drho}};
  const Layout3 g{cap, nx, ny, nz, h2};
  return launch3_tiled<DamMass<3>, false>(f, kmax, g, {kc, hinv, two_nu}, tx,
                                          smem_bytes,
                                          static_cast<cudaStream_t>(stream));
}

int dambreak_mass_sweep_3d_direct(const float* occ, const float* x0,
                                  const float* x1, const float* x2,
                                  const float* v0, const float* v1,
                                  const float* v2, const float* rho,
                                  const int* kmax, float* drho, int cap,
                                  int nx, int ny, int nz, float h2, float kc,
                                  float hinv, float two_nu, void* stream) {
  Planes<8, 1> f{{occ, x0, x1, x2, v0, v1, v2, rho}, {drho}};
  const Layout3 g{cap, nx, ny, nz, h2};
  return launch3<DamMass<3>, false>(f, kmax, g, {kc, hinv, two_nu},
                                    static_cast<cudaStream_t>(stream));
}

int dambreak_force_sweep_3d(const float* occ, const float* x0, const float* x1,
                            const float* x2, const float* v0, const float* v1,
                            const float* v2, const float* pterm,
                            const float* fluid, const int* kmax, float* dv0,
                            float* dv1, float* dv2, int cap, int nx, int ny,
                            int nz, float h2, float kc, float hinv,
                            float visc_c, int tx, int smem_bytes,
                            void* stream) {
  Planes<9, 3> f{{occ, x0, x1, x2, v0, v1, v2, pterm, fluid}, {dv0, dv1, dv2}};
  const Layout3 g{cap, nx, ny, nz, h2};
  return launch3_tiled<DamForce<3>, false>(f, kmax, g, {kc, hinv, visc_c}, tx,
                                           smem_bytes,
                                           static_cast<cudaStream_t>(stream));
}

int dambreak_force_sweep_3d_direct(const float* occ, const float* x0,
                                   const float* x1, const float* x2,
                                   const float* v0, const float* v1,
                                   const float* v2, const float* pterm,
                                   const float* fluid, const int* kmax,
                                   float* dv0, float* dv1, float* dv2, int cap,
                                   int nx, int ny, int nz, float h2, float kc,
                                   float hinv, float visc_c, void* stream) {
  Planes<9, 3> f{{occ, x0, x1, x2, v0, v1, v2, pterm, fluid}, {dv0, dv1, dv2}};
  const Layout3 g{cap, nx, ny, nz, h2};
  return launch3<DamForce<3>, false>(f, kmax, g, {kc, hinv, visc_c},
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
