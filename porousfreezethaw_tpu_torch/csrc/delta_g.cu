// Increment-form (delta) stage of the freezing model: G = f(w + d) - f(w).
//
// Replaces the Pallas kernel make_delta_g -> build_g
// (porousfreezethaw_tpu/ops/pallas/stencil.py:973-1122, pallas_call at
// :1112; arithmetic models/freezing/delta.py:101-244).  Each point
// evaluates the exact expansion of delta.py term by term, in the same
// association, so that no term subtracts two large nearly equal values:
//
//   d = h * (c_0 K1 + sum_j c_j G_j)   assembled once per point
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
// The shard entry (pft_delta_g_shard, K2s: Pallas shard_ghosts, is_top and
// plane_rows/row_window, stencil.py:935-953, :1001-1035, :1052-1057) runs
// the same kernel on one shard of a device mesh, for every tail: the z
// neighbours beyond the shard's planes are (u, p, gl) and the increment
// assembled from caller-supplied ghost stacks of raw edge planes (w, K1,
// G_j) with the arithmetic of the own planes; the Dirichlet overwrites of
// the top ghost (old u := D1, increment := dDi) apply only on the global top
// shard (is_top); the y window is that of the stage kernel (stage.cuh), so
// the output and the eps max cover the own rows only.  The single-device
// entry is the same kernel on a shard that is the whole grid (own rows
// [0, Y), is_top, no ghost stacks: the mirror below plane 0 and above plane
// Z-1), so ptxas compiles one body for both entries and a sharded solve
// equals the single-device one bit for bit.  pft_delta_g_dev is the
// single-device entry with (h, D1, dDi) read from the control block of
// the device-resident controller (control.cuh, control.cu): the same
// kernel template with DEV set; pft_delta_g_shard_dev is the shard entry
// with DEV set, the device-resident loop on a mesh (parallel/fused.py).
//
// What bounds it on Hopper.  Bytes: a launch reads w (3 planes) and nk
// increments (2 planes each) once and writes 2 planes, 76 MB at MR for the
// mix of nk = 1, 2, 3 and the tail: 0.023 ms at 3.35 TB/s.  Operations:
// about 310 float32 operations per point (chip_smoke.py DELTA_OPS), 0.009
// ms at MR at 67 TFLOP/s, only 2.5x under the bytes; in instructions the
// point arithmetic, with its IEEE divisions and square roots, is several
// hundred per point, so the issue slots bound the kernel as much as the
// bytes do.  The design therefore spends as few instructions as it can on
// moving data, and keeps every lane busy:
//
// * The tile engine of tile.cuh: one block per tile of 50 x 10 own points,
//   one thread per point, marching a chunk of planes sized so that the
//   blocks fill the card in whole waves; each plane's raw input rows over
//   the tile and its halo copied to shared memory with cp.async (16, 8 or 4
//   bytes), a ring of RING planes in flight, one barrier per plane.
// * Each thread assembles (u, p, gl, a, b) of its own point once per plane
//   (the first threads also a halo cell) into shared memory, for two
//   planes, z and z+1; it reads its four in-plane neighbours from there and
//   keeps z-1, z and z+1 of its own column in registers, with the raw w,
//   K1, G3 and G4 of its point for the stage-5 tail.  The planes below and
//   above a chunk are copied for the tile's own rows only.
// * nk is a template parameter, so the copies and the assembly are
//   unrolled without guards.
//
// On the H100 this runs at about 43% of the bytes bound at MR (PERF.md).
#include "control.cuh"
#include "tile.cuh"

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

// The SigmaP1-P models (1, 11) round every operation of rhs_delta_point on
// its own, apart from the face fluxes; the other models let nvcc and ptxas
// contract multiply-adds.  (That split dates from when the shard and the
// single-device entries were two instantiations, which ptxas contracted
// differently in those models; with one body for both it is kept so that
// the point arithmetic, and with it the models' results, stay as they were.)
template <int MODE>
constexpr bool uncontracted = MODE == SIGMAP || MODE == SIGMAP_FROZEN_U;

constexpr int NPT = 5;     // assembled planes: u, p, gl, a, b
// raw planes in flight: RING - 1 while a plane is computed
constexpr int RING = 3;
static_assert(RING >= 3, "bad ring");

struct DeltaArgs {
    const float* plane[RAW];  // the raw input planes at z = 0: w's u, p, gl
                              // (3, Z, Y, X), then the (u, p) of K1 and the
                              // G_j, each (2, Z, Y, X)
    float hc[3];           // h*c_a, formed in float32
    float h, D1, dDi;
    float* out;            // G (2, Z, Y, X), or y_spec / dy with STAGE5
    float* eps;            // per-block partial max (STAGE5)
    int64_t eps_n;         // its slots
    Grid g;
    int vec;               // floats per copy: 4, 2 or 1 (alignment of rows)
    int tz;                // planes per block (the chunk)
};

constexpr int delta_smem_bytes(int nk) {
    return tile_smem_bytes<NPT, RING>(nk);
}

// (u, p, gl) and the increment (a, b) of the raw values r of one point.
// The multiply-adds are explicit, so every call site rounds alike.
template <int NK>
__device__ __forceinline__ DPt assemble(const DeltaArgs& a, const float* r) {
    float d_u = __fmul_rn(a.hc[0], r[3]);
    float d_p = __fmul_rn(a.hc[0], r[4]);
#pragma unroll
    for (int q = 1; q < NK; ++q) {
        d_u = __fmaf_rn(a.hc[q], r[3 + 2 * q], d_u);
        d_p = __fmaf_rn(a.hc[q], r[4 + 2 * q], d_p);
    }
    return DPt{r[0], r[1], r[2], d_u, d_p};
}

__device__ __forceinline__ DPt tile_point(const float* pt, int cell) {
    return DPt{pt[cell], pt[HALO_CELLS + cell], pt[2 * HALO_CELLS + cell],
               pt[3 * HALO_CELLS + cell], pt[4 * HALO_CELLS + cell]};
}

__device__ __forceinline__ void store_point(float* pt, int cell,
                                            const DPt& v) {
    pt[cell] = v.u;
    pt[HALO_CELLS + cell] = v.p;
    pt[2 * HALO_CELLS + cell] = v.gl;
    pt[3 * HALO_CELLS + cell] = v.a;
    pt[4 * HALO_CELLS + cell] = v.b;
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

// The point at place i of the raw buffer raw; its raw tail inputs (w's u,
// p, then the (u, p) of K1, G3 and G4) go to tl when TL.
template <int NK, bool TL = false>
__device__ __forceinline__ DPt raw_point(const DeltaArgs& a, const float* raw,
                                         int i, float* tl = nullptr) {
    float r[3 + 2 * NK];
    raw_values<NK>(raw, i, r);
    if constexpr (TL) {
        tl[0] = r[0];
        tl[1] = r[1];
#pragma unroll
        for (int q = 0; q < 6; ++q) tl[2 + q] = r[3 + q];
    }
    return assemble<NK>(a, r);
}

// The scalars of a _dev entry's stage from the control block: h, D1 and
// dDi, and h*c_a formed in float32 as delta_args forms them on the host.
__device__ __forceinline__ void delta_scalars(DeltaArgs& a,
                                              const DevStage& d) {
    const Control& c = *d.ctl;
    a.h = c.h32;
    a.D1 = c.D1;
    a.dDi = c.dD[d.stage];
#pragma unroll
    for (int q = 0; q < 3; ++q) a.hc[q] = __fmul_rn(a.h, d.coef[q]);
}

// The whole stage for the tile of this block over its chunk of planes.
// TAIL: 0 = G, 1 = y_spec (emit="y"), 2 = dy (emit="dy"); the tails take
// NK = 3 (K1, G3, G4).
template <int MODE, int NK, int TAIL>
__device__ __forceinline__ void delta_body(const Consts& c,
                                           const DeltaArgs& a,
                                           const ShardArgs& s) {
    constexpr bool STAGE5 = TAIL > 0, EMIT_DY = TAIL == 2;
    constexpr int NR = 3 + 2 * NK;
    extern __shared__ __align__(16) float smem[];
    __shared__ int rowoff[ROWS];
    // RING raw planes, then the assembled planes of two consecutive z
    float* const raw = smem;
    float* const pts = smem + RING * NR * RAW_PLANE;
    const int X = a.g.X, Z = a.g.Z;
    const int x0 = blockIdx.x * TILE_X, yo0 = blockIdx.y * TILE_Y;
    const int z0 = blockIdx.z * a.tz, z1 = min(z0 + a.tz, Z);
    const int tid = threadIdx.x;
    const int x = x0 + tid % TILE_X, yo = yo0 + tid / TILE_X;  // own row yo
    const bool point = tid < TILE_POINTS;
    const bool own = point && x < X && yo < s.Yl;
    const TileMap m = tile_map(X, x0, a.vec);
    const int xlim = min(X, x0 + TILE_X + 1);
    if (tid < ROWS) rowoff[tid] = row_offset(s, X, yo0, tid);
    __syncthreads();
    // the output's plane and variable strides (own rows only)
    const int64_t oP = (int64_t)s.Yl * X, oV = (int64_t)Z * oP;

    // planes k = 0 .. n-1 are z0 - 1 .. z1; plane k lives in the raw
    // buffer k % RING and, assembled, in pts[k % 2].  A raw buffer is
    // refilled after the barrier that follows its plane's assembly: RING -
    // 1 planes are in flight while a plane is computed.
    const int n = z1 - z0 + 2;
    auto raw_of = [&](int k) { return raw + (k % RING) * NR * RAW_PLANE; };
    auto pts_of = [&](int k) { return pts + (k & 1) * NPT * HALO_CELLS; };
    auto stage = [&](int k) {
        if (k < n)
            stage_plane<NK>(a, s, rowoff, m.xa, xlim, z0 - 1 + k,
                            k > 0 && k < n - 1, raw_of(k));
        else
            copy_commit();
    };
#pragma unroll
    for (int k = 0; k < RING; ++k) stage(k);
    copy_wait<RING - 2>();                  // planes 0 and 1 have arrived
    __syncthreads();
    float tl[8] = {}, tn[8] = {};   // tail inputs of planes z and z+1
    DPt below{}, cur{};
    if (point) {
        below = raw_point<NK>(a, raw_of(0), m.ctr_raw);
        cur = raw_point<NK, STAGE5>(a, raw_of(1), m.ctr_raw, tl);
        store_point(pts_of(1), m.ctr, cur);
    }
    if (m.halo >= 0)
        store_point(pts_of(1), m.halo,
                    raw_point<NK>(a, raw_of(1), m.halo_raw));
    float mx = 0.0f;
#pragma unroll 1
    for (int k = 1; k < n - 1; ++k) {
        const int z = z0 - 1 + k;
        // plane k + 1 has arrived (the first time, planes RING .. RING + 1
        // are not yet staged)
        if (k == 1)
            copy_wait<RING - 3>();
        else
            copy_wait<RING - 2>();
        __syncthreads();    // pts_of(k) is whole, pts_of(k + 1) is free
        if (k == 1)
            stage(RING);    // into the buffer of plane 0
        stage(k + RING);    // into the buffer of plane k
        // plane k + 1: the next own plane, or the plane above the chunk
        // (above the top: old u := D1 and the increment := dDi on the
        // global top)
        DPt above{};
        if (point) {
            above = raw_point<NK, STAGE5>(a, raw_of(k + 1), m.ctr_raw, tn);
            if (k + 1 < n - 1) {
                store_point(pts_of(k + 1), m.ctr, above);
            } else if (z1 == Z && s.is_top) {
                above.u = a.D1;
                above.a = a.dDi;
            }
        }
        if (k + 1 < n - 1 && m.halo >= 0)
            store_point(pts_of(k + 1), m.halo,
                        raw_point<NK>(a, raw_of(k + 1), m.halo_raw));
        if (own) {
            const float* pt = pts_of(k);
            float gu, gp;
            rhs_delta_point<MODE>(c, cur, tile_point(pt, m.ctr - 1),
                                  tile_point(pt, m.ctr + 1),
                                  tile_point(pt, m.ctr - HALO_X),
                                  tile_point(pt, m.ctr + HALO_X), below,
                                  above, gu, gp);
            const int64_t o = (int64_t)z * oP + (int64_t)yo * X + x;
            if (!STAGE5) {
                a.out[o] = gu;
                a.out[oV + o] = gp;
            } else {
                // tl: w's u, p, then the (u, p) of K1, G3 and G4 of the
                // stage-5 combination
                const float h3 = a.h / 3.0f;
                const float g5[2] = {gu, gp};
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const float k1 = tl[2 + v], g3 = tl[4 + v];
                    const float g4 = tl[6 + v];
                    float err = -0.9f * g3 + 0.8f * g4 - 0.1f * g5[v];
                    mx = nan_max(mx, fabsf(err));
                    if (EMIT_DY) {
                        const float u_term = __fmul_rn(a.h, k1);
                        const float x_term = __fmul_rn(
                            h3, __fadd_rn(__fmul_rn(2.0f, g4),
                                          __fmul_rn(0.5f, g5[v])));
                        a.out[v * oV + o] = __fadd_rn(u_term, x_term);
                    } else {
                        a.out[v * oV + o] = tl[v] + a.h * k1
                                            + h3 * (2.0f * g4 + 0.5f * g5[v]);
                    }
                }
            }
        }
        below = cur;
        cur = above;
        if (STAGE5) {
#pragma unroll
            for (int q = 0; q < 8; ++q) tl[q] = tn[q];
        }
    }
    if (STAGE5) block_max_store<TILE_THREADS>(mx, a.eps);
}

// DEV: the _dev entry, whose scalars come from the control block d.ctl and
// which returns at once once the loop has halted.
template <int MODE, int NK, int TAIL, bool DEV>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM)
delta_g_kernel(const Consts c, const DeltaArgs a, const ShardArgs s,
               const DevStage d) {
    if constexpr (DEV) {
        if (d.ctl->halt) return;
        DeltaArgs b = a;
        delta_scalars(b, d);
        delta_body<MODE, NK, TAIL>(c, b, s);
    } else {
        delta_body<MODE, NK, TAIL>(c, a, s);
    }
}

// Computes the grid of a launch; with out, only stores it there, else
// launches, when a tail's grid has no more blocks than eps has slots (as
// many, for a _dev tail: the control kernel reduces every slot).
template <int MODE, int NK, int TAIL, bool DEV>
static int launch_as(const Consts& c, DeltaArgs a, const ShardArgs& sa,
                     const DevStage& d, cudaStream_t s, TileGrid* out) {
    static int resident[MAX_DEVICES] = {};      // blocks on the card
    int cap = 0;
    const int rc = resident_blocks(delta_g_kernel<MODE, NK, TAIL, DEV>,
                                   delta_smem_bytes(NK), resident, cap);
    if (rc) return rc;
    const TileGrid dg = tile_grid(cap, a.g.Z, sa.Yl, a.g.X);
    if (out) {
        *out = dg;
        return 0;
    }
    const int64_t blocks = (int64_t)dg.grid.x * dg.grid.y * dg.grid.z;
    if (TAIL && (blocks > a.eps_n || (DEV && blocks != a.eps_n)))
        return 1012;
    a.tz = dg.tz;
    delta_g_kernel<MODE, NK, TAIL, DEV><<<dg.grid, TILE_THREADS,
                                          delta_smem_bytes(NK), s>>>(
        c, a, sa, d);
    return (int)cudaGetLastError();
}

template <int MODE, int NK, int TAIL>
static int launch_kernel(const Consts& c, const DeltaArgs& a,
                         const ShardArgs& sa, const DevStage* d,
                         cudaStream_t s, TileGrid* out) {
    return d ? launch_as<MODE, NK, TAIL, true>(c, a, sa, *d, s, out)
             : launch_as<MODE, NK, TAIL, false>(c, a, sa, DevStage{}, s, out);
}

// A single-device launch is a shard that holds the whole grid (see the
// top of the file).
template <int MODE>
static int launch_mode(const Consts& c, const DeltaArgs& a,
                       const ShardArgs& sa, const DevStage* d, int nk,
                       int tail, cudaStream_t s, TileGrid* out) {
    if (tail == 2) return launch_kernel<MODE, 3, 2>(c, a, sa, d, s, out);
    if (tail == 1) return launch_kernel<MODE, 3, 1>(c, a, sa, d, s, out);
    if (nk == 1) return launch_kernel<MODE, 1, 0>(c, a, sa, d, s, out);
    if (nk == 2) return launch_kernel<MODE, 2, 0>(c, a, sa, d, s, out);
    return launch_kernel<MODE, 3, 0>(c, a, sa, d, s, out);
}

static int launch(const Consts& c, const DeltaArgs& a, const ShardArgs& sa,
                  int mode, int nk, int tail, cudaStream_t s,
                  TileGrid* out = nullptr, const DevStage* d = nullptr) {
    switch (mode) {
        case GRADP:
            return launch_mode<GRADP>(c, a, sa, d, nk, tail, s, out);
        case SIGMAP:
            return launch_mode<SIGMAP>(c, a, sa, d, nk, tail, s, out);
        case TEMP: return launch_mode<TEMP>(c, a, sa, d, nk, tail, s, out);
        case GRADP_FROZEN_U:
            return launch_mode<GRADP_FROZEN_U>(c, a, sa, d, nk, tail, s, out);
        case SIGMAP_FROZEN_U:
            return launch_mode<SIGMAP_FROZEN_U>(c, a, sa, d, nk, tail, s,
                                                out);
        default: return 1004;
    }
}

// The argument block of one delta launch; returns 0 or 1000 + n.
static int delta_args(DeltaArgs& a, int nk, int tail, float h, float D1,
                      float dDi, const float* coefs, const float* w,
                      const float* k0, const float* k1, const float* k2,
                      float* out, float* eps, long long eps_n, int Z, int Y,
                      int X) {
    if (nk < 1 || nk > 3) return 1001;
    if (tail < 0 || tail > 2) return 1005;
    if (tail && nk != 3) return 1002;
    if (Z < 1 || Y < 1 || X < 1) return 1003;
    const int64_t V = (int64_t)Z * Y * X;
    const float* k[3] = {k0, k1, k2};
    for (int q = 0; q < RAW; ++q)
        a.plane[q] = q < 3 ? w + q * V
            : q < 3 + 2 * nk ? k[(q - 3) / 2] + ((q - 3) % 2) * V : nullptr;
    for (int q = 0; q < 3; ++q) a.hc[q] = q < nk ? h * coefs[q] : 0.0f;
    a.vec = copy_width(a.plane, 3 + 2 * nk, X);
    a.h = h;
    a.D1 = D1;
    a.dDi = dDi;
    a.out = out;
    a.eps = eps;
    a.eps_n = eps_n;
    a.g = Grid{Z, Y, X};
    return 0;
}

}  // namespace pft

using namespace pft;

extern "C" {

// G of one increment-form stage (tail = 0), or the stage-5 tail with its
// eps partials: y_spec (tail = 1, emit="y") or dy (tail = 2, emit="dy").
// consts and coefs are host arrays; every other pointer is device memory.
// eps has eps_n slots, pft_delta_eps_blocks of the launch.  Returns
// cudaGetLastError() after the launch; 1000 + n for bad arguments (1012:
// eps is too short for the launch's grid).
int pft_delta_g(const float* consts, int mode, int nk, int tail, float h,
                float D1, float dDi, const float* coefs, const float* w,
                const float* k0, const float* k1, const float* k2,
                float* out, float* eps, int Z, int Y, int X, void* stream,
                long long eps_n) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    return launch(*reinterpret_cast<const Consts*>(consts), a,
                  whole_grid(Y), mode, nk, tail,
                  static_cast<cudaStream_t>(stream));
}

// The _dev entry of pft_delta_g: h, D1 and dDi of stage `stage` (1-4) of
// the next attempt come from the control block ctl (device memory), and
// the launch returns at once once the loop has halted; coefs are the c_a,
// from which the kernel forms h*c_a as the host does for pft_delta_g.  A
// tail's eps must have exactly the launch's slots.  Returns as
// pft_delta_g; 1013 for a bad ctl or stage.
int pft_delta_g_dev(const float* consts, int mode, int nk, int tail,
                    const void* ctl, int stage, const float* coefs,
                    const float* w, const float* k0, const float* k1,
                    const float* k2, float* out, float* eps, int Z, int Y,
                    int X, void* stream, long long eps_n) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, 0.0f, 0.0f, 0.0f, coefs, w, k0, k1, k2,
                         out, eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 1 || stage > 4) return 1013;
    const DevStage d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const Consts*>(consts), a,
                  whole_grid(Y), mode, nk, tail,
                  static_cast<cudaStream_t>(stream), nullptr, &d);
}

// K2s: the delta stage on one shard, every tail.  Shapes and the y window
// as pft_fused_stage_shard; is_top gates the Dirichlet overwrites of ghi.
int pft_delta_g_shard(const float* consts, int mode, int nk, int tail,
                      float h, float D1, float dDi, const float* coefs,
                      const float* w, const float* k0, const float* k1,
                      const float* k2, float* out, float* eps, int Z, int Y,
                      int X, void* stream, long long eps_n,
                      const float* glo, const float* ghi, int is_top, int r0,
                      int Yl, int y0, int Yg) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, h, D1, dDi, coefs, w, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    ShardArgs sa{glo, ghi, PART_ALL, r0, Yl, y0, Yg, is_top};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    a.vec = ghost_width(a.vec, glo, ghi);
    return launch(*reinterpret_cast<const Consts*>(consts), a, sa, mode,
                  nk, tail, static_cast<cudaStream_t>(stream));
}

// The _dev entry of pft_delta_g_shard: (ctl, stage) as pft_delta_g_dev
// takes them (h, D1 and dDi from the control block), the shard options
// and is_top as pft_delta_g_shard.  A tail's eps must have exactly the
// launch's slots.  Returns as pft_delta_g_shard; 1013 for a bad ctl or
// stage.
int pft_delta_g_shard_dev(const float* consts, int mode, int nk, int tail,
                          const void* ctl, int stage, const float* coefs,
                          const float* w, const float* k0, const float* k1,
                          const float* k2, float* out, float* eps, int Z,
                          int Y, int X, void* stream, long long eps_n,
                          const float* glo, const float* ghi, int is_top,
                          int r0, int Yl, int y0, int Yg) {
    DeltaArgs a;
    int bad = delta_args(a, nk, tail, 0.0f, 0.0f, 0.0f, coefs, w, k0, k1, k2,
                         out, eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 1 || stage > 4) return 1013;
    ShardArgs sa{glo, ghi, PART_ALL, r0, Yl, y0, Yg, is_top};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    a.vec = ghost_width(a.vec, glo, ghi);
    const DevStage d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const Consts*>(consts), a, sa, mode,
                  nk, tail, static_cast<cudaStream_t>(stream), nullptr, &d);
}

// eps partial slots of a stage-5 launch (tail 1 or 2) of either entry over
// Yl own rows on the current device: the blocks of its grid; -1 for bad
// arguments or a failed query.
long long pft_delta_eps_blocks(int mode, int tail, int Z, int Yl, int X) {
    if (tail < 1 || tail > 2 || Z < 1 || Yl < 1 || X < 1) return -1;
    DeltaArgs a{};
    a.g = Grid{Z, Yl, X};
    TileGrid dg;
    if (launch(Consts{}, a, whole_grid(Yl), mode, 3, tail, nullptr, &dg))
        return -1;
    return (long long)dg.grid.x * dg.grid.y * dg.grid.z;
}

}  // extern "C"
