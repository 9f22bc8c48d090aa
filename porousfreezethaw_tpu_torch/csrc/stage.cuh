// The classic Merson stage of the freezing model, shared by fused_stage.cu
// (K1: the stage on a plain state) and fused_attempt.cu (K4: the same stage
// on one slot of a double-buffered state).  Both kernels instantiate
// stage_body, so their arithmetic is the same code and their results agree
// bit for bit.
//
//   K = f(t_s, aux),  aux = w + sum_a (h*c_a) K_a  over (u, p); gl static
//
// with the FVM mirror boundary everywhere and the Dirichlet top on the
// temperature: the *combined* u ghost above the last plane is D(t_s), with
// t_s given as float32 and the phase switch decided in float32, as the
// Pallas kernel receives and decides it.  Models 0/1/2/10/11.  With STAGE5
// the body is the Merson tail instead: K5 stays in registers and it writes
// y_spec = w + (h/3)(0.5(K1 + K5) + 2 K4) and one NaN-propagating partial
// max of |0.2 K1 - 0.9 K3 + 0.8 K4 - 0.1 K5| per block (the host takes the
// max over the partials).
#pragma once

#include "freezing.cuh"

namespace pft {

struct Pt { float u, p, gl; };

struct StageArgs {
    const float* w;        // (3, Z, Y, X)
    const float* k[3];     // nk inputs, each (2, Z, Y, X)
    float hc[3];           // h*c_a, formed in float32
    int nk;
    float t, h;
    float* out;            // K (2, Z, Y, X), or y_spec with STAGE5
    float* eps;            // per-block partial max (STAGE5)
    Grid g;
};

// aux at (z, y, x): w + sum_a (h c_a) K_a, accumulated in the Pallas order
__device__ __forceinline__ Pt aux_at(const StageArgs& a, int64_t i) {
    const int64_t V = a.g.var();
    float u = a.w[i], p = a.w[V + i];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        if (q < a.nk) {
            u = u + a.hc[q] * a.k[q][i];
            p = p + a.hc[q] * a.k[q][V + i];
        }
    }
    return Pt{u, p, a.w[2 * V + i]};
}

__device__ __forceinline__ float face(const Consts& c, const Pt& n,
                                      const Pt& o) {
    return lam(c, 0.5f * (n.p + o.p), 0.5f * (n.gl + o.gl)) * (n.u - o.u);
}

// (du, dp) of _compute_rhs from the centre and its six neighbours
template <int MODE>
__device__ __forceinline__ void rhs_point(const Consts& c, const Pt& o,
                                          const Pt& xm, const Pt& xp,
                                          const Pt& ym, const Pt& yp,
                                          const Pt& zm, const Pt& zp,
                                          float& du, float& dp) {
    const float u = o.u, p = o.p, gl = o.gl;
    const float wind = water_indicator(c, gl);
    if (MODE == TEMP) {
        float x = fabsf(c.gamma * (u - c.u_star));
        float e = expf(-x);
        float sech = 2.0f * e / (1.0f + e * e);
        float dp_du = c.neg_half_gamma * (sech * sech) * wind;
        float denom = rho(c, p, gl) * (cp(c, p, gl) - c.L * dp_du);
        float div = c.h1_2 * (face(c, xm, o) + face(c, xp, o));
        div += c.h2_2 * (face(c, ym, o) + face(c, yp, o));
        div += c.h3_2 * (face(c, zm, o) + face(c, zp, o));
        du = div / denom;
        dp = dp_du * du;
        return;
    }
    float d = c.h1_2 * (xm.p + xp.p - 2.0f * p)
              + c.h2_2 * (ym.p + yp.p - 2.0f * p)
              + c.h3_2 * (zm.p + zp.p - 2.0f * p);
    if (MODE == GRADP || MODE == GRADP_FROZEN_U) {
        float qx = c.h1d2 * (xp.p - xm.p);
        float qy = c.h2d2 * (yp.p - ym.p);
        float qz = c.h3d2 * (zp.p - zm.p);
        float gn = sqrtf(qx * qx + qy * qy + qz * qz) + c.eps_reg;
        d += c.A * p * (1.0f - p) * (p - 0.5f) - c.B * gn * (u - c.u_star);
    } else {
        float pq = p * (1.0f - p);
        d += c.A * p * (1.0f - p) * (p - 0.5f)
             - c.C * sshape(c, p) * sshape(c, 1.0f - p) * nan_max(pq, 0.0f)
               * (u - c.u_star);
    }
    dp = d / c.alpha * wind;
    if (MODE == GRADP_FROZEN_U || MODE == SIGMAP_FROZEN_U) {
        du = 0.0f;
        return;
    }
    float div = c.h1_2 * (face(c, xm, o) + face(c, xp, o));
    div += c.h2_2 * (face(c, ym, o) + face(c, yp, o));
    div += c.h3_2 * (face(c, zm, o) + face(c, zp, o));
    du = (div / rho(c, p, gl) + c.L * dp) / cp(c, p, gl);
}

// The whole stage for the (x, y) column of this thread over its ZCHUNK
// planes; the kernels are this body with their own pointer set-up.
template <int MODE, bool STAGE5>
__device__ __forceinline__ void stage_body(const Consts& c,
                                           const StageArgs& a) {
    const int x = blockIdx.x * BX + threadIdx.x;
    const int y = blockIdx.y * BY + threadIdx.y;
    const int z0 = blockIdx.z * ZCHUNK;
    const int X = a.g.X, Y = a.g.Y, Z = a.g.Z;
    const int64_t P = a.g.plane(), V = a.g.var();
    float m = 0.0f;
    if (x < X && y < Y) {
        const int xm = x > 0 ? x - 1 : x, xp = x < X - 1 ? x + 1 : x;
        const int ym = y > 0 ? y - 1 : y, yp = y < Y - 1 ? y + 1 : y;
        const float D = a.t < c.phase_switch_time ? c.top_temp1 : c.top_temp2;
        const int64_t col = (int64_t)y * X + x;
        Pt below = aux_at(a, (int64_t)(z0 > 0 ? z0 - 1 : 0) * P + col);
        Pt cur = aux_at(a, (int64_t)z0 * P + col);
        const int z1 = min(z0 + ZCHUNK, Z);
        for (int z = z0; z < z1; ++z) {
            const int64_t i = (int64_t)z * P + col;
            // mirror for p and gl, Dirichlet ghost for u at the top
            Pt above = z + 1 < Z ? aux_at(a, i + P) : Pt{D, cur.p, cur.gl};
            const int64_t row = (int64_t)z * P;
            Pt nxm = aux_at(a, row + (int64_t)y * X + xm);
            Pt nxp = aux_at(a, row + (int64_t)y * X + xp);
            Pt nym = aux_at(a, row + (int64_t)ym * X + x);
            Pt nyp = aux_at(a, row + (int64_t)yp * X + x);
            float du, dp;
            rhs_point<MODE>(c, cur, nxm, nxp, nym, nyp, below, above, du, dp);
            if (!STAGE5) {
                a.out[i] = du;
                a.out[V + i] = dp;
            } else {
                // k[0], k[1], k[2] are K1, K3, K4 of the stage-5 combination
                const float h3 = a.h / 3.0f;
                const float k5[2] = {du, dp};
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int64_t j = v * V + i;
                    const float k1 = a.k[0][j], k3 = a.k[1][j], k4 = a.k[2][j];
                    float err = 0.2f * k1 - 0.9f * k3 + 0.8f * k4
                                - 0.1f * k5[v];
                    m = nan_max(m, fabsf(err));
                    a.out[j] = a.w[j] + h3 * (0.5f * (k1 + k5[v]) + 2.0f * k4);
                }
            }
            below = cur;
            cur = above;
        }
    }
    if (STAGE5) block_max_store(m, a.eps);
}

// Fills the argument block of one stage; the kernels' C entries share it.
// Returns 0, or 1000 + n for bad arguments.
inline int stage_args(StageArgs& a, int nk, int stage5, float t, float h,
                      const float* coefs, const float* w, const float* k0,
                      const float* k1, const float* k2, float* out,
                      float* eps, int Z, int Y, int X) {
    if (nk < 0 || nk > 3) return 1001;
    if (stage5 && nk != 3) return 1002;
    if (Z < 1 || Y < 1 || X < 1) return 1003;
    a.w = w;
    a.k[0] = k0; a.k[1] = k1; a.k[2] = k2;
    for (int q = 0; q < 3; ++q) a.hc[q] = q < nk ? h * coefs[q] : 0.0f;
    a.nk = nk;
    a.t = t;
    a.h = h;
    a.out = out;
    a.eps = eps;
    a.g = Grid{Z, Y, X};
    return 0;
}

}  // namespace pft
