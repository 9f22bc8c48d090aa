// Increment-form (delta) stage of the freezing model: G = f(w + d) - f(w).
//
// Replaces the Pallas kernel make_delta_g -> build_g
// (porousfreezethaw_tpu/ops/pallas/stencil.py:973-1122, pallas_call at
// :1112; arithmetic models/freezing/delta.py:101-244).  Each thread
// evaluates the exact expansion of delta.py term by term, in the same
// association, so that no term subtracts two large nearly equal values:
//
//   d = h * (c_0 K1 + sum_j c_j G_j)   assembled in registers per point
//   old u ghost above the top := D1 = D(t1); increment ghost := dDi =
//   D(t_i) - D(t1), both formed on the host from the float64 t; every
//   other boundary is the mirror (clamped index).
//
// With STAGE5 the kernel is the Merson tail: G5 stays in registers, the
// kernel writes y_spec = w + h K1 + (h/3)(2 G4 + 0.5 G5) (the association
// of stencil.py:1078-1082) and one NaN-propagating partial max of
// |-0.9 G3 + 0.8 G4 - 0.1 G5| per block.
//
// With EMIT_DY as well (emit="dy", stencil.py:1059-1076) the tail writes the
// bare increment dy = h K1 + (h/3)(2 G4 + 0.5 G5) instead, the input of the
// compensated (TwoSum) commit.  The low bits of dy are what that commit
// keeps, so the final products and sum are formed with __fmul_rn and
// __fadd_rn, which nvcc never contracts into a multiply-add: the kernel and
// its plain PyTorch version then round dy alike.  The eps partials are those
// of the y_spec tail.  That launch moves 11 float32 planes (w, K1, G3, G4
// in; dy out), 88 MB at MR (100x100x200): 0.026 ms at 3.35 TB/s.
//
// With SHARD (pft_delta_g_shard, K2s: Pallas shard_ghosts, is_top and
// plane_rows/row_window, stencil.py:935-953, :1001-1035, :1052-1057) the
// kernel runs on one shard of a device mesh, for every tail: the z
// neighbours beyond the shard's planes are (u, p, gl) and the increment
// assembled in-kernel from caller-supplied ghost stacks of raw edge planes
// (w, K1, G_j) with the arithmetic of the own planes; the Dirichlet
// overwrites of the top ghost (old u := D1, increment := dDi) apply only on
// the global top shard (is_top); the y window is that of the stage kernel
// (stage.cuh), so the output and the eps max cover the own rows only.
// A sharded solve equals the single-device one bit for bit; for that the
// SigmaP1-P models round their point arithmetic uncontracted (see
// uncontracted below).
//
// What bounds it on Hopper: memory traffic, as for the classic stage (about
// 47 float32 single-variable planes per attempt at any grid), though this
// kernel does several times the classic stage's flops per cell.  The design
// is the classic stage's: one thread per (x, y) column, x fastest for
// coalesced loads, ZCHUNK planes marched with the z-1/z/z+1 values of
// (u, p, gl, a, b) in registers, in-plane neighbours recomputed from
// global memory through L1/L2.  Shared-memory tiling and TMA are later work.
#include "freezing.cuh"

namespace pft {

struct DPt { float u, p, gl, a, b; };

// float32 add, subtract and multiply.  With RN each rounds on its own:
// __fadd_rn, __fsub_rn and __fmul_rn are never contracted into a
// multiply-add.  Without RN they are the plain operators, which nvcc and
// ptxas may contract as they see fit.
template <bool RN>
__device__ __forceinline__ float fadd(float a, float b) {
    if constexpr (RN) return __fadd_rn(a, b); else return a + b;
}
template <bool RN>
__device__ __forceinline__ float fsub(float a, float b) {
    if constexpr (RN) return __fsub_rn(a, b); else return a - b;
}
template <bool RN>
__device__ __forceinline__ float fmul(float a, float b) {
    if constexpr (RN) return __fmul_rn(a, b); else return a * b;
}

// In the SigmaP1-P models (1, 11) ptxas contracts the point arithmetic
// into multiply-adds differently in the single-device and the shard
// instantiations of the kernel, and a sharded solve must equal the
// single-device one bit for bit.  So those models round every operation
// of rhs_delta_point on its own, apart from the face fluxes, which both
// instantiations contract alike.  The other models keep the faster
// contracted arithmetic, where both instantiations round alike already.
template <int MODE>
constexpr bool uncontracted = MODE == SIGMAP || MODE == SIGMAP_FROZEN_U;

struct DeltaArgs {
    const float* w;        // (3, Z, Y, X)
    const float* k[3];     // K1 then G_j, each (2, Z, Y, X)
    float hc[3];           // h*c_a, formed in float32
    int nk;
    float h, D1, dDi;
    float* out;            // G (2, Z, Y, X), or y_spec / dy with STAGE5
    float* eps;            // per-block partial max (STAGE5)
    Grid g;
};

// (u, p, gl) of w and the increment (a, b) at element i of the planes w
// (variable stride wV) and k0..k2 (stride kV)
__device__ __forceinline__ DPt load_of(const DeltaArgs& a, const float* w,
                                       int64_t wV, const float* k0,
                                       const float* k1, const float* k2,
                                       int64_t kV, int64_t i) {
    const float* k[3] = {k0, k1, k2};
    float d_u = a.hc[0] * k[0][i];
    float d_p = a.hc[0] * k[0][kV + i];
#pragma unroll
    for (int q = 1; q < 3; ++q) {
        if (q < a.nk) {
            d_u = d_u + a.hc[q] * k[q][i];
            d_p = d_p + a.hc[q] * k[q][kV + i];
        }
    }
    return DPt{w[i], w[wV + i], w[2 * wV + i], d_u, d_p};
}

__device__ __forceinline__ DPt load(const DeltaArgs& a, int64_t i) {
    const int64_t V = a.g.var();
    return load_of(a, a.w, V, a.k[0], a.k[1], a.k[2], V, i);
}

// the same at column col of a ghost stack (3 + 2 nk, Y, X)
__device__ __forceinline__ DPt load_ghost(const DeltaArgs& a, const float* g,
                                          int64_t col) {
    const int64_t P = a.g.plane();
    return load_of(a, g, P, g + 3 * P, g + 5 * P, g + 7 * P, P, col);
}

__device__ __forceinline__ float tanh_exp(float x) {
    float e = expf(-2.0f * fabsf(x));
    float t = (1.0f - e) / (1.0f + e);
    return x < 0.0f ? -t : t;
}

// sshape of freezing.cuh, in the same association
template <bool RN>
__device__ __forceinline__ float sshape_of(const Consts& c, float x) {
    float xs = fsub<RN>(x, c.p_eps0);
    float mid = fmul<RN>(fmul<RN>(xs, xs),
                         fsub<RN>(c.eps2_3, fmul<RN>(c.eps3_2, xs)));
    return x <= c.p_eps0 ? 0.0f : (x >= c.p_eps1 ? 1.0f : mid);
}

// sshape(x + dx) - sshape(x), exact on the mid branch (delta.py _dsshape)
template <bool RN>
__device__ __forceinline__ float dsshape(const Consts& c, float x, float dx) {
    float xs = fsub<RN>(x, c.p_eps0);
    float x_n = fadd<RN>(x, dx);
    float cube = fadd<RN>(fadd<RN>(fmul<RN>(fmul<RN>(3.0f, xs), xs),
                                   fmul<RN>(fmul<RN>(3.0f, xs), dx)),
                          fmul<RN>(dx, dx));
    float dmid = fsub<RN>(
        fmul<RN>(fmul<RN>(c.eps2_3, dx), fadd<RN>(fmul<RN>(2.0f, xs), dx)),
        fmul<RN>(fmul<RN>(c.eps3_2, dx), cube));
    bool both_mid = x > c.p_eps0 && x < c.p_eps1 && x_n > c.p_eps0
                    && x_n < c.p_eps1;
    float direct = fsub<RN>(sshape_of<RN>(c, x_n), sshape_of<RN>(c, x));
    return both_mid ? dmid : direct;
}

// blend of freezing.cuh (rho, cp), in the same association
template <bool RN>
__device__ __forceinline__ float blend_of(float p, float gl, float glass,
                                          float ice, float water) {
    return fadd<RN>(fmul<RN>(gl, glass),
                    fmul<RN>(fsub<RN>(1.0f, gl),
                             fadd<RN>(fmul<RN>(p, ice),
                                      fmul<RN>(fsub<RN>(1.0f, p), water))));
}

// one face of diffusion_parts: adds the old flux and its exact increment
__device__ __forceinline__ void face(const Consts& c, float w_ax,
                                     const DPt& o, const DPt& n, bool first,
                                     float& D_old, float& dD) {
    float pbar = 0.5f * (o.p + n.p);
    float gbar = 0.5f * (o.gl + n.gl);
    float lam_o = lam(c, pbar, gbar);
    float du_o = n.u - o.u;
    float da = n.a - o.a;
    float bbar = 0.5f * (o.b + n.b);
    float lamp = (1.0f - gbar) * c.lam_p_slope;
    float fo = w_ax * (lam_o * du_o);
    float fd = w_ax * (lam_o * da + bbar * lamp * (du_o + da));
    D_old = first ? fo : D_old + fo;
    dD = first ? fd : dD + fd;
}

// (Gu, Gp) of compute_rhs_delta from the centre and its six neighbours
template <int MODE>
__device__ __forceinline__ void rhs_delta_point(
        const Consts& c, const DPt& o, const DPt& xm, const DPt& xp,
        const DPt& ym, const DPt& yp, const DPt& zm, const DPt& zp,
        float& gu, float& gp) {
    constexpr bool RN = uncontracted<MODE>;
    const float u = o.u, p = o.p, gl = o.gl, a = o.a, b = o.b;
    const float wind = nan_max(fsub<RN>(1.0f, fmul<RN>(c.zeta, gl)), 0.0f);
    const float um = u - c.u_star;

    float D_old = 0.0f, dD = 0.0f;
    face(c, c.h1_2, o, xm, true, D_old, dD);
    face(c, c.h1_2, o, xp, false, D_old, dD);
    face(c, c.h2_2, o, ym, false, D_old, dD);
    face(c, c.h2_2, o, yp, false, D_old, dD);
    face(c, c.h3_2, o, zm, false, D_old, dD);
    face(c, c.h3_2, o, zp, false, D_old, dD);

    const float rho_o = blend_of<RN>(p, gl, c.glass_rho, c.ice_rho,
                                     c.water_rho);
    const float drho = fmul<RN>(b, fmul<RN>(fsub<RN>(1.0f, gl),
                                            c.rho_p_slope));
    const float rho_n = fadd<RN>(rho_o, drho);
    const float cp_o = blend_of<RN>(p, gl, c.glass_cp, c.ice_cp, c.water_cp);
    const float dcp = fmul<RN>(b, fmul<RN>(fsub<RN>(1.0f, gl),
                                           c.cp_p_slope));
    const float cp_n = fadd<RN>(cp_o, dcp);

    if (MODE == TEMP) {
        // model 2: du = div(lam grad u) / (rho (cp - L phf'(u)))
        float x = c.gamma * um;
        float tx = tanh_exp(x);
        float td = tanh_exp(c.gamma * a);
        float den = 1.0f + tx * td;
        float dtanh = den > 0.5f
            ? td * (1.0f - tx * tx) / nan_max(den, 0.25f)
            : tanh_exp(x + c.gamma * a) - tx;
        float tx_n = tx + dtanh;
        float sech2_o = 1.0f - tx * tx;
        float dsech2 = -dtanh * (tx_n + tx);
        float dpdu_o = c.neg_half_gamma * sech2_o * wind;
        float ddpdu = c.neg_half_gamma * dsech2 * wind;
        float dpdu_n = dpdu_o + ddpdu;
        float denom_o = rho_o * (cp_o - c.L * dpdu_o);
        float ddenom = drho * (cp_o - c.L * dpdu_o)
                       + rho_n * (dcp - c.L * ddpdu);
        float denom_n = denom_o + ddenom;
        float du_o = D_old / denom_o;
        float ddu = (dD * denom_o - D_old * ddenom) / (denom_n * denom_o);
        gu = ddu;
        gp = ddpdu * du_o + dpdu_n * ddu;
        return;
    }

    // models 0/1 (+frozen-u 10/11)
    float lap_old = fmul<RN>(c.h1_2, fsub<RN>(xm.p, p));
    float dlap = fmul<RN>(c.h1_2, fsub<RN>(xm.b, b));
    lap_old = fadd<RN>(lap_old, fmul<RN>(c.h1_2, fsub<RN>(xp.p, p)));
    dlap = fadd<RN>(dlap, fmul<RN>(c.h1_2, fsub<RN>(xp.b, b)));
    lap_old = fadd<RN>(lap_old, fmul<RN>(c.h2_2, fsub<RN>(ym.p, p)));
    dlap = fadd<RN>(dlap, fmul<RN>(c.h2_2, fsub<RN>(ym.b, b)));
    lap_old = fadd<RN>(lap_old, fmul<RN>(c.h2_2, fsub<RN>(yp.p, p)));
    dlap = fadd<RN>(dlap, fmul<RN>(c.h2_2, fsub<RN>(yp.b, b)));
    lap_old = fadd<RN>(lap_old, fmul<RN>(c.h3_2, fsub<RN>(zm.p, p)));
    dlap = fadd<RN>(dlap, fmul<RN>(c.h3_2, fsub<RN>(zm.b, b)));
    lap_old = fadd<RN>(lap_old, fmul<RN>(c.h3_2, fsub<RN>(zp.p, p)));
    dlap = fadd<RN>(dlap, fmul<RN>(c.h3_2, fsub<RN>(zp.b, b)));

    // double-well g(p) = p(1-p)(p-1/2)
    const float g_o = fmul<RN>(fmul<RN>(p, fsub<RN>(1.0f, p)),
                               fsub<RN>(p, 0.5f));
    const float gprime = fsub<RN>(
        fmul<RN>(fsub<RN>(3.0f, fmul<RN>(3.0f, p)), p), 0.5f);
    const float dg = fmul<RN>(
        b, fsub<RN>(fadd<RN>(gprime,
                             fmul<RN>(b, fsub<RN>(1.5f, fmul<RN>(3.0f, p)))),
                    fmul<RN>(b, b)));

    float R_old, dR;
    if (MODE == GRADP || MODE == GRADP_FROZEN_U) {
        float qx = c.h1d2 * (xp.p - xm.p);
        float qy = c.h2d2 * (yp.p - ym.p);
        float qz = c.h3d2 * (zp.p - zm.p);
        float dx_ = c.h1d2 * (xp.b - xm.b);
        float dy_ = c.h2d2 * (yp.b - ym.b);
        float dz_ = c.h3d2 * (zp.b - zm.b);
        float S_o = qx * qx + qy * qy + qz * qz;
        float dS = dx_ * (2.0f * qx + dx_) + dy_ * (2.0f * qy + dy_)
                   + dz_ * (2.0f * qz + dz_);
        float r_o = sqrtf(S_o);
        float r_n = sqrtf(S_o + dS);
        float dgn = dS / (r_o + r_n + 1e-30f);
        float gn_o = r_o + c.eps_reg;
        float gn_n = gn_o + dgn;
        R_old = c.A * g_o - c.B * gn_o * um;
        dR = c.A * dg - c.B * (dgn * um + gn_n * a);
    } else {
        const float q = fsub<RN>(1.0f, p);
        float s1_o = sshape_of<RN>(c, p);
        float s2_o = sshape_of<RN>(c, q);
        float ds1 = dsshape<RN>(c, p, b);
        float ds2 = dsshape<RN>(c, q, -b);
        float s1_n = fadd<RN>(s1_o, ds1);
        float s2_n = fadd<RN>(s2_o, ds2);
        float pq_o = fmul<RN>(p, q);
        float dpq = fmul<RN>(b, fsub<RN>(fsub<RN>(1.0f, fmul<RN>(2.0f, p)),
                                         b));
        float pq_n = fadd<RN>(pq_o, dpq);
        float m_o = nan_max(pq_o, 0.0f);
        float m_n = nan_max(pq_n, 0.0f);
        float dm = (pq_o > 0.0f && pq_n > 0.0f) ? dpq : fsub<RN>(m_n, m_o);
        // telescoped product difference of s1*s2*m*(u-u*)
        const float t1 = fmul<RN>(fmul<RN>(fmul<RN>(ds1, s2_o), m_o), um);
        const float t2 = fmul<RN>(fmul<RN>(fmul<RN>(s1_n, ds2), m_o), um);
        const float t3 = fmul<RN>(fmul<RN>(fmul<RN>(s1_n, s2_n), dm), um);
        const float t4 = fmul<RN>(fmul<RN>(fmul<RN>(s1_n, s2_n), m_n), a);
        float dT = fadd<RN>(fadd<RN>(fadd<RN>(t1, t2), t3), t4);
        R_old = fsub<RN>(
            fmul<RN>(c.A, g_o),
            fmul<RN>(fmul<RN>(fmul<RN>(fmul<RN>(c.C, s1_o), s2_o), m_o), um));
        dR = fsub<RN>(fmul<RN>(c.A, dg), fmul<RN>(c.C, dT));
    }

    const float inv_alpha_wind = wind / c.alpha;
    const float dp_old = fmul<RN>(fadd<RN>(lap_old, R_old), inv_alpha_wind);
    const float ddp = fmul<RN>(fadd<RN>(dlap, dR), inv_alpha_wind);
    gp = ddp;
    if (MODE == GRADP_FROZEN_U || MODE == SIGMAP_FROZEN_U) {
        gu = 0.0f;
        return;
    }
    const float X_o = D_old / rho_o;
    const float dX = fsub<RN>(fmul<RN>(dD, rho_o), fmul<RN>(D_old, drho))
                     / fmul<RN>(rho_n, rho_o);
    const float N_o = fadd<RN>(X_o, fmul<RN>(c.L, dp_old));
    const float dN = fadd<RN>(dX, fmul<RN>(c.L, ddp));
    gu = fsub<RN>(fmul<RN>(dN, cp_o), fmul<RN>(N_o, dcp))
         / fmul<RN>(cp_n, cp_o);
}

template <int MODE, bool STAGE5, bool EMIT_DY, bool SHARD = false>
__global__ void __launch_bounds__(BX * BY)
delta_g_kernel(const Consts c, const DeltaArgs a,
               const ShardArgs s) {
    const int x = blockIdx.x * BX + threadIdx.x;
    const int yo = blockIdx.y * BY + threadIdx.y;   // own row
    const int z0 = blockIdx.z * ZCHUNK;
    const int X = a.g.X, Y = a.g.Y, Z = a.g.Z;
    const int64_t P = a.g.plane(), V = a.g.var();
    const int Yo = SHARD ? s.Yl : Y;
    // the output's plane and variable strides (own rows only)
    const int64_t oP = (int64_t)Yo * X, oV = (int64_t)Z * oP;
    float m = 0.0f;
    if (x < X && yo < Yo) {
        const int xm = x > 0 ? x - 1 : x, xp = x < X - 1 ? x + 1 : x;
        int y, ym, yp;
        if (SHARD) {
            const int gy = s.y0 + yo;
            y = s.r0 + yo;
            ym = gy > 0 ? y - 1 : y;
            yp = gy < s.Yg - 1 ? y + 1 : y;
        } else {
            y = yo;
            ym = y > 0 ? y - 1 : y;
            yp = y < Y - 1 ? y + 1 : y;
        }
        const int64_t col = (int64_t)y * X + x;
        DPt below = (SHARD && z0 == 0)
            ? load_ghost(a, s.glo, col)
            : load(a, (int64_t)(z0 > 0 ? z0 - 1 : 0) * P + col);
        DPt cur = load(a, (int64_t)z0 * P + col);
        const int z1 = min(z0 + ZCHUNK, Z);
        for (int z = z0; z < z1; ++z) {
            const int64_t i = (int64_t)z * P + col;
            const int64_t o = (int64_t)z * oP + (int64_t)yo * X + x;
            // top ghost: old u := D1, increment a := dDi; p, gl, b mirror.
            // A shard reads its ghost stack, overwritten on the global top.
            DPt above;
            if (z + 1 < Z) {
                above = load(a, i + P);
            } else if (SHARD) {
                above = load_ghost(a, s.ghi, col);
                if (s.is_top) {
                    above.u = a.D1;
                    above.a = a.dDi;
                }
            } else {
                above = DPt{a.D1, cur.p, cur.gl, a.dDi, cur.b};
            }
            const int64_t row = (int64_t)z * P;
            DPt nxm = load(a, row + (int64_t)y * X + xm);
            DPt nxp = load(a, row + (int64_t)y * X + xp);
            DPt nym = load(a, row + (int64_t)ym * X + x);
            DPt nyp = load(a, row + (int64_t)yp * X + x);
            float gu, gp;
            rhs_delta_point<MODE>(c, cur, nxm, nxp, nym, nyp, below, above,
                                  gu, gp);
            if (!STAGE5) {
                a.out[o] = gu;
                a.out[oV + o] = gp;
            } else {
                // k[0], k[1], k[2] are K1, G3, G4 of the stage-5 combination
                const float h3 = a.h / 3.0f;
                const float g5[2] = {gu, gp};
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int64_t j = v * V + i;
                    const float k1 = a.k[0][j], g3 = a.k[1][j], g4 = a.k[2][j];
                    float err = -0.9f * g3 + 0.8f * g4 - 0.1f * g5[v];
                    m = nan_max(m, fabsf(err));
                    if (EMIT_DY) {
                        const float u_term = __fmul_rn(a.h, k1);
                        const float x_term = __fmul_rn(
                            h3, __fadd_rn(__fmul_rn(2.0f, g4),
                                          __fmul_rn(0.5f, g5[v])));
                        a.out[v * oV + o] = __fadd_rn(u_term, x_term);
                    } else {
                        a.out[v * oV + o] = a.w[j] + a.h * k1
                                            + h3 * (2.0f * g4 + 0.5f * g5[v]);
                    }
                }
            }
            below = cur;
            cur = above;
        }
    }
    if (STAGE5) block_max_store(m, a.eps);
}

// tail: 0 = G, 1 = y_spec (emit="y"), 2 = dy (emit="dy")
template <int MODE>
static void launch_mode(const Consts& c, const DeltaArgs& a, int tail,
                        cudaStream_t s) {
    dim3 grid = launch_grid(a.g.Z, a.g.Y, a.g.X), block(BX, BY);
    const ShardArgs none{};
    if (tail == 2)
        delta_g_kernel<MODE, true, true><<<grid, block, 0, s>>>(c, a, none);
    else if (tail == 1)
        delta_g_kernel<MODE, true, false><<<grid, block, 0, s>>>(c, a, none);
    else
        delta_g_kernel<MODE, false, false><<<grid, block, 0, s>>>(c, a, none);
}

template <int MODE>
static void launch_shard_mode(const Consts& c, const DeltaArgs& a,
                              const ShardArgs& sa, int tail, cudaStream_t s) {
    dim3 grid = shard_grid(PART_ALL, a.g.Z, sa.Yl, a.g.X), block(BX, BY);
    if (tail == 2)
        delta_g_kernel<MODE, true, true, true><<<grid, block, 0, s>>>(
            c, a, sa);
    else if (tail == 1)
        delta_g_kernel<MODE, true, false, true><<<grid, block, 0, s>>>(
            c, a, sa);
    else
        delta_g_kernel<MODE, false, false, true><<<grid, block, 0, s>>>(
            c, a, sa);
}

// The argument block of one delta launch; returns 0 or 1000 + n.
static int delta_args(DeltaArgs& a, int nk, int tail, float h, float D1,
                      float dDi, const float* coefs, const float* w,
                      const float* k0, const float* k1, const float* k2,
                      float* out, float* eps, int Z, int Y, int X) {
    if (nk < 1 || nk > 3) return 1001;
    if (tail < 0 || tail > 2) return 1005;
    if (tail && nk != 3) return 1002;
    if (Z < 1 || Y < 1 || X < 1) return 1003;
    a.w = w;
    a.k[0] = k0; a.k[1] = k1; a.k[2] = k2;
    for (int q = 0; q < 3; ++q) a.hc[q] = q < nk ? h * coefs[q] : 0.0f;
    a.nk = nk;
    a.h = h;
    a.D1 = D1;
    a.dDi = dDi;
    a.out = out;
    a.eps = eps;
    a.g = Grid{Z, Y, X};
    return 0;
}

}  // namespace pft

using namespace pft;

extern "C" {

// G of one increment-form stage (tail = 0), or the stage-5 tail with its
// eps partials: y_spec (tail = 1, emit="y") or dy (tail = 2, emit="dy").
// consts and coefs are host arrays; every other pointer is device memory.
// Returns cudaGetLastError() after the launch; 1000 + n for bad arguments.
int pft_delta_g(const float* consts, int mode, int nk, int tail, float h,
                float D1, float dDi, const float* coefs, const float* w,
                const float* k0, const float* k1, const float* k2,
                float* out, float* eps, int Z, int Y, int X, void* stream) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out,
                         eps, Z, Y, X);
    if (bad) return bad;
    Consts c = *reinterpret_cast<const Consts*>(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GRADP: launch_mode<GRADP>(c, a, tail, s); break;
        case SIGMAP: launch_mode<SIGMAP>(c, a, tail, s); break;
        case TEMP: launch_mode<TEMP>(c, a, tail, s); break;
        case GRADP_FROZEN_U: launch_mode<GRADP_FROZEN_U>(c, a, tail, s); break;
        case SIGMAP_FROZEN_U: launch_mode<SIGMAP_FROZEN_U>(c, a, tail, s); break;
        default: return 1004;
    }
    return (int)cudaGetLastError();
}

// K2s: the delta stage on one shard, every tail.  Shapes and the y window
// as pft_fused_stage_shard; is_top gates the Dirichlet overwrites of ghi.
int pft_delta_g_shard(const float* consts, int mode, int nk, int tail,
                      float h, float D1, float dDi, const float* coefs,
                      const float* w, const float* k0, const float* k1,
                      const float* k2, float* out, float* eps, int Z, int Y,
                      int X, void* stream, const float* glo,
                      const float* ghi, int is_top, int r0, int Yl, int y0,
                      int Yg) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out,
                         eps, Z, Y, X);
    if (bad) return bad;
    ShardArgs sa{glo, ghi, PART_ALL, r0, Yl, y0, Yg, is_top};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    Consts c = *reinterpret_cast<const Consts*>(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GRADP: launch_shard_mode<GRADP>(c, a, sa, tail, s); break;
        case SIGMAP: launch_shard_mode<SIGMAP>(c, a, sa, tail, s); break;
        case TEMP: launch_shard_mode<TEMP>(c, a, sa, tail, s); break;
        case GRADP_FROZEN_U:
            launch_shard_mode<GRADP_FROZEN_U>(c, a, sa, tail, s); break;
        case SIGMAP_FROZEN_U:
            launch_shard_mode<SIGMAP_FROZEN_U>(c, a, sa, tail, s); break;
        default: return 1004;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
