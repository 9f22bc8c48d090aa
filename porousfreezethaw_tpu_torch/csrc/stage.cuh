// The classic Merson stage of the freezing model, shared by fused_stage.cu
// (K1, K1s and K3: the stage on a plain state or a shard of it) and
// fused_attempt.cu (K4: the same stage on one slot of a double-buffered
// state).  Every kernel instantiates stage_body, so their arithmetic is the
// same code and their results agree bit for bit.
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
//
// The body runs on one shard of a device mesh (parallel/fused.py): the z
// neighbours below plane 0 and above plane Z-1 come from caller-supplied
// ghost stacks of raw edge planes, one per input, combined with the same
// arithmetic as the shard's own planes (so a sharded stage equals the
// single-device stage bit for bit); the chain-end boundaries, the Dirichlet
// top included, are in the ghost content.  The inputs may carry ghost rows
// in y: the shard's own rows are [r0, r0 + Yl) and the y mirror is decided
// on the global row y0 + row of the global Y, so a chain-end ghost row is
// never read.  The output and the eps partials cover the own rows only,
// over the planes of ``part``: all, the interior [1, Z-1), which reads no
// ghost, or the edge planes 0 and Z-1.  A single-device launch is the body
// on a shard that holds the whole grid: own rows [0, Y), no ghost stacks,
// the mirror below plane 0 and, with is_top, the Dirichlet combined ghost
// above plane Z-1 (u := D(t_s), p and gl mirrored).
//
// What bounds it on Hopper.  Bytes: a launch reads w (3 planes) and nk K
// inputs (2 planes each) once and writes 2 planes: 40 MB at MR (100 x 100 x
// 200) for nk = 0, 0.012 ms at 3.35 TB/s, and an attempt's five launches
// 328 MB.  Operations: about 160 float32 operations per point
// (chip_smoke.py STAGE_OPS) and 20 per K input, 0.005 ms at MR at 67
// TFLOP/s, well under the bytes.  The design is the delta kernel's, on the
// tile engine of tile.cuh (tiles of 50 x 10 own points, each input plane's
// rows over the tile and its halo copied once to shared memory with
// cp.async, a ring of planes in flight, a z-chunk sized to whole waves), so
// that each input element is read from device memory once per plane, apart
// from the halo and the planes around a chunk:
//
// * Each thread assembles aux = (u, p, gl) of its own point once per plane
//   (the first threads also a halo cell) into shared memory, for two
//   planes, z and z+1; it reads its four in-plane neighbours from there and
//   keeps z-1, z and z+1 of its own column in registers.  The stage-5 tail
//   takes w, K1, K3 and K4 at its point from the raw tile: a raw buffer is
//   refilled only after the barrier that follows its plane's computation,
//   so the ring holds one plane more than the delta kernel's for the same
//   planes in flight.
// * nk is a template parameter, so the copies and the assembly are
//   unrolled without guards.
//
// On the H100 (PERF.md) K1 at nk = 0 takes about 2.1x a tensor copy of its
// bytes, the stage-5 tail about 1.35x: the cost per point that does not
// scale with the bytes (the point arithmetic with its IEEE divisions, the
// assembly and the barrier of each plane) bounds the launches with few
// inputs, the bytes those with many.
//
// The body is templated on the field's width T.  In float32 it is the
// stage above.  In float64 (the single-device _dev entry of fused_stage.cu,
// the f64 path's attempt) it is the plain right-hand side's stage, each
// operation correctly rounded: stage_scalars reads the float64 stage time
// ts64 and the scale s of the stage (h/3, h/6, h/8 or h: the control
// block's hs); the inputs are aux = w + (sum_a c_a K_a) s, as
// merson_stages forms them, and the tail y_spec = w + (0.5 (K1 + K5) +
// 2 K4)(h/3) and |((0.2 K1 - 0.9 K3) + 0.8 K4) - 0.1 K5|, as RHSAttempt
// forms them; the point arithmetic keeps make_rhs's association; every +,
// - and * is rounded on its own (freezing.cuh add_t, sub_t, mul_t), and
// the Dirichlet top is decided on the float64 t_s, as
// equation.DirichletTop decides it.  The host's own PyTorch kernels are
// an ulp off that here and there (the CPU's sqrt and exp are not
// correctly rounded; on the card a division by a scalar is a product
// with its reciprocal).
#pragma once

#include "control.cuh"
#include "tile.cuh"

namespace pft {

template <class T>
struct Pt { T u, p, gl; };

constexpr int NPT = 3;     // assembled planes: u, p, gl
// raw planes in the ring: RING - 2 in flight while a plane is computed, as
// the buffer of the computed plane is kept for the stage-5 tail
constexpr int RING = 4;
static_assert(RING >= 3, "bad ring");

template <class T>
struct StageArgsT {
    const T* plane[RAW];   // the raw input planes at z = 0: w's u, p, gl
                           // (3, Z, Y, X), then the (u, p) of each K
                           // input, each (2, Z, Y, X)
    T hc[3];               // float32: h*c_a, formed in float32; float64:
                           // the c_a
    T t, h;                // the stage time and h (float64: the scale s)
    T* out;                // K (2, Z, Yl, X), or y_spec with STAGE5
    T* eps;                // per-block partial max (STAGE5)
    int64_t eps_n;         // its slots
    Grid g;
    int vec;               // elements per copy: 4, 2 or 1 floats, 2 or 1
                           // doubles (alignment of rows)
    int tz;                // planes per block (the chunk)
};
using StageArgs = StageArgsT<float>;

template <class T = float>
constexpr int stage_smem_bytes(int nk) {
    return tile_smem_bytes<NPT, RING, T>(nk);
}

// The scalars of a _dev entry's stage from the control block: t_s and h,
// and h*c_a formed in float32 as stage_args forms them on the host.
__device__ __forceinline__ void stage_scalars(StageArgs& a,
                                              const DevStage& d) {
    const Control& c = *d.ctl;
    a.t = c.ts[d.stage];
    a.h = c.h32;
#pragma unroll
    for (int q = 0; q < 3; ++q) a.hc[q] = __fmul_rn(a.h, d.coef[q]);
}

// ... of the float64 entry: the stage times t, t + h/3, t + h/3, t + h/2,
// t + h of stages 0-4 (ts64) and the scale of stages 1-4, h/3, h/6, h/8
// and h (hs), as merson_stages reads them; the c_a as given
__device__ __forceinline__ void stage_scalars(StageArgsT<double>& a,
                                              const DevStageT<double>& d) {
    const Control& c = *d.ctl;
    a.t = c.ts64[d.stage - (d.stage >= 2)];
    a.h = c.hs[d.stage == 0 ? 3 : d.stage - 1];
#pragma unroll
    for (int q = 0; q < 3; ++q) a.hc[q] = d.coef[q];
}

// aux of the raw values r of one point.  float32: w + sum_a (h c_a) K_a,
// accumulated in the Pallas order (stencil.py _core), the multiply-adds
// explicit, so every call site rounds alike.  float64: w + (sum_a c_a K_a)
// s, each operation rounded on its own, as merson_stages forms it.
template <int NK, class T>
__device__ __forceinline__ Pt<T> assemble(const StageArgsT<T>& a,
                                          const T* r) {
    if constexpr (sizeof(T) == 4) {
        float u = r[0], p = r[1];
#pragma unroll
        for (int q = 0; q < NK; ++q) {
            u = __fmaf_rn(a.hc[q], r[3 + 2 * q], u);
            p = __fmaf_rn(a.hc[q], r[4 + 2 * q], p);
        }
        return Pt<T>{u, p, r[2]};
    } else if constexpr (NK == 0) {
        return Pt<T>{r[0], r[1], r[2]};
    } else {
        double su = __dmul_rn(a.hc[0], r[3]), sp = __dmul_rn(a.hc[0], r[4]);
#pragma unroll
        for (int q = 1; q < NK; ++q) {
            su = __dadd_rn(su, __dmul_rn(a.hc[q], r[3 + 2 * q]));
            sp = __dadd_rn(sp, __dmul_rn(a.hc[q], r[4 + 2 * q]));
        }
        return Pt<T>{__dadd_rn(r[0], __dmul_rn(su, a.h)),
                     __dadd_rn(r[1], __dmul_rn(sp, a.h)), r[2]};
    }
}

// The point at place i of the raw buffer raw
template <int NK, class T>
__device__ __forceinline__ Pt<T> raw_point(const StageArgsT<T>& a,
                                           const T* raw, int i) {
    T r[3 + 2 * NK];
    raw_values<NK>(raw, i, r);
    return assemble<NK>(a, r);
}

template <class T>
__device__ __forceinline__ Pt<T> tile_point(const T* pt, int cell) {
    return Pt<T>{pt[cell], pt[HALO_CELLS + cell], pt[2 * HALO_CELLS + cell]};
}

template <class T>
__device__ __forceinline__ void store_point(T* pt, int cell, const Pt<T>& v) {
    pt[cell] = v.u;
    pt[HALO_CELLS + cell] = v.p;
    pt[2 * HALO_CELLS + cell] = v.gl;
}

template <class T>
__device__ __forceinline__ T face(const ConstsT<T>& c, const Pt<T>& n,
                                  const Pt<T>& o) {
    return mul_t(lam(c, mul_t(T(0.5), add_t(n.p, o.p)),
                     mul_t(T(0.5), add_t(n.gl, o.gl))),
                 sub_t(n.u, o.u));
}

// div(lambda grad u) at o from its six neighbours' face fluxes, summed by
// axis in make_rhs's order
template <class T>
__device__ __forceinline__ T div_faces(const ConstsT<T>& c, const Pt<T>& o,
                                       const Pt<T>& xm, const Pt<T>& xp,
                                       const Pt<T>& ym, const Pt<T>& yp,
                                       const Pt<T>& zm, const Pt<T>& zp) {
    T div = mul_t(c.h1_2, add_t(face(c, xm, o), face(c, xp, o)));
    div = add_t(div, mul_t(c.h2_2, add_t(face(c, ym, o), face(c, yp, o))));
    return add_t(div, mul_t(c.h3_2, add_t(face(c, zm, o), face(c, zp, o))));
}

// (du, dp) of _compute_rhs from the centre and its six neighbours, every
// operation in make_rhs's association (add_t, sub_t, mul_t: uncontracted
// in float64)
template <int MODE, class T>
__device__ __forceinline__ void rhs_point(const ConstsT<T>& c, const Pt<T>& o,
                                          const Pt<T>& xm, const Pt<T>& xp,
                                          const Pt<T>& ym, const Pt<T>& yp,
                                          const Pt<T>& zm, const Pt<T>& zp,
                                          T& du, T& dp) {
    const T u = o.u, p = o.p, gl = o.gl;
    const T wind = water_indicator(c, gl);
    if (MODE == TEMP) {
        T x = abs_t(mul_t(c.gamma, sub_t(u, c.u_star)));
        T e = exp_t(-x);
        T sech = mul_t(T(2), e) / add_t(T(1), mul_t(e, e));
        T dp_du = mul_t(mul_t(c.neg_half_gamma, mul_t(sech, sech)), wind);
        T denom = mul_t(rho(c, p, gl),
                        sub_t(cp(c, p, gl), mul_t(c.L, dp_du)));
        du = div_faces(c, o, xm, xp, ym, yp, zm, zp) / denom;
        dp = mul_t(dp_du, du);
        return;
    }
    T d = add_t(add_t(mul_t(c.h1_2, sub_t(add_t(xm.p, xp.p),
                                          mul_t(T(2), p))),
                      mul_t(c.h2_2, sub_t(add_t(ym.p, yp.p),
                                          mul_t(T(2), p)))),
                mul_t(c.h3_2, sub_t(add_t(zm.p, zp.p), mul_t(T(2), p))));
    // each branch forms the double well A p (1 - p) (p - 1/2) where the
    // float32 kernel always has: nvcc's choice of multiply-adds follows the
    // order of the code
    if (MODE == GRADP || MODE == GRADP_FROZEN_U) {
        T qx = mul_t(c.h1d2, sub_t(xp.p, xm.p));
        T qy = mul_t(c.h2d2, sub_t(yp.p, ym.p));
        T qz = mul_t(c.h3d2, sub_t(zp.p, zm.p));
        T gn = add_t(sqrt_t(add_t(add_t(mul_t(qx, qx), mul_t(qy, qy)),
                                  mul_t(qz, qz))),
                     c.eps_reg);
        d = add_t(d, sub_t(mul_t(mul_t(mul_t(c.A, p), sub_t(T(1), p)),
                                 sub_t(p, T(0.5))),
                           mul_t(mul_t(c.B, gn), sub_t(u, c.u_star))));
    } else {
        T pq = mul_t(p, sub_t(T(1), p));
        d = add_t(d, sub_t(mul_t(mul_t(mul_t(c.A, p), sub_t(T(1), p)),
                                 sub_t(p, T(0.5))),
                           mul_t(mul_t(mul_t(mul_t(c.C, sshape(c, p)),
                                             sshape(c, sub_t(T(1), p))),
                                       nan_max(pq, T(0))),
                                 sub_t(u, c.u_star))));
    }
    dp = mul_t(d / c.alpha, wind);
    if (MODE == GRADP_FROZEN_U || MODE == SIGMAP_FROZEN_U) {
        du = T(0);
        return;
    }
    du = add_t(div_faces(c, o, xm, xp, ym, yp, zm, zp) / rho(c, p, gl),
               mul_t(c.L, dp)) / cp(c, p, gl);
}

// The stage-5 combination of one variable at a point in merson_solve's
// association: the error ((0.2 K1 - 0.9 K3) + 0.8 K4) - 0.1 K5 and the
// update w + h3 (0.5 (K1 + K5) + 2 K4), their operands in the float32
// kernel's order (nvcc's multiply-adds follow the order of the code)
template <class T>
__device__ __forceinline__ T merson_err(T k1, T k3, T k4, T k5) {
    return sub_t(add_t(sub_t(mul_t(T(0.2), k1), mul_t(T(0.9), k3)),
                       mul_t(T(0.8), k4)),
                 mul_t(T(0.1), k5));
}
template <class T>
__device__ __forceinline__ T merson_update(T w, T k1, T k4, T k5, T h3) {
    return add_t(w, mul_t(h3, add_t(mul_t(T(0.5), add_t(k1, k5)),
                                    mul_t(T(2), k4))));
}

// The planes [z0, z1) of block z-index bz for a launch over part with
// chunks of tz planes; the edge part has two blocks in z, plane 0 and plane
// Z-1.
__device__ __forceinline__ void part_planes(int part, int Z, int tz, int bz,
                                            int& z0, int& z1) {
    if (part == PART_EDGE) {
        z0 = bz == 0 ? 0 : Z - 1;
        z1 = z0 + 1;
        return;
    }
    const int lo = part == PART_INTERIOR ? 1 : 0;
    const int hi = part == PART_INTERIOR ? Z - 1 : Z;
    z0 = lo + bz * tz;
    z1 = min(z0 + tz, hi);
}

// The whole stage for the tile of this block over its chunk of planes; the
// kernels are this body with their own pointer set-up.
template <int MODE, int NK, bool STAGE5, class T>
__device__ __forceinline__ void stage_body(const ConstsT<T>& c,
                                           const StageArgsT<T>& a,
                                           const ShardArgs& s) {
    constexpr int NR = 3 + 2 * NK, RP = RAW_PLANE_T<T>;
    extern __shared__ __align__(16) float smem[];
    __shared__ int rowoff[ROWS];
    // RING raw planes, then the assembled planes of two consecutive z
    T* const raw = reinterpret_cast<T*>(smem);
    T* const pts = raw + RING * NR * RP;
    const int X = a.g.X, Z = a.g.Z;
    const int x0 = blockIdx.x * TILE_X, yo0 = blockIdx.y * TILE_Y;
    int z0, z1;
    part_planes(s.part, Z, a.tz, blockIdx.z, z0, z1);
    const int tid = threadIdx.x;
    const int x = x0 + tid % TILE_X, yo = yo0 + tid / TILE_X;  // own row yo
    const bool point = tid < TILE_POINTS;
    const bool own = point && x < X && yo < s.Yl;
    const TileMap m = tile_map<T>(X, x0, a.vec);
    const int xlim = min(X, x0 + TILE_X + 1);
    if (tid < ROWS) rowoff[tid] = row_offset(s, X, yo0, tid);
    __syncthreads();
    // the output's plane and variable strides (own rows only)
    const int64_t oP = (int64_t)s.Yl * X, oV = (int64_t)Z * oP;

    // planes k = 0 .. n-1 are z0 - 1 .. z1; plane k lives in the raw
    // buffer k % RING and, assembled, in pts[k % 2].  The raw buffer of
    // plane k is refilled after the barrier that follows its computation
    // (the stage-5 tail reads it then): RING - 2 planes are in flight while
    // a plane is computed.
    const int n = z1 - z0 + 2;
    auto raw_of = [&](int k) { return raw + (k % RING) * NR * RP; };
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
    Pt<T> below{}, cur{};
    if (point) {
        below = raw_point<NK>(a, raw_of(0), m.ctr_raw);
        cur = raw_point<NK>(a, raw_of(1), m.ctr_raw);
        store_point(pts_of(1), m.ctr, cur);
    }
    if (m.halo >= 0)
        store_point(pts_of(1), m.halo,
                    raw_point<NK>(a, raw_of(1), m.halo_raw));
    T mx = T(0);
#pragma unroll 1
    for (int k = 1; k < n - 1; ++k) {
        const int z = z0 - 1 + k;
        copy_wait<RING - 3>();              // plane k + 1 has arrived
        // pts_of(k) is whole, pts_of(k + 1) and the raw buffer of plane
        // k - 1 are free
        __syncthreads();
        stage(k - 1 + RING);
        // plane k + 1: the next own plane, or the plane above the chunk
        // (above the top of a single-device launch: u := D, p and gl the
        // mirror)
        Pt<T> above{};
        if (point) {
            above = raw_point<NK>(a, raw_of(k + 1), m.ctr_raw);
            if (k + 1 < n - 1)
                store_point(pts_of(k + 1), m.ctr, above);
            else if (z1 == Z && s.is_top)
                above.u = a.t < c.phase_switch_time ? c.top_temp1
                                                    : c.top_temp2;
        }
        if (k + 1 < n - 1 && m.halo >= 0)
            store_point(pts_of(k + 1), m.halo,
                        raw_point<NK>(a, raw_of(k + 1), m.halo_raw));
        if (own) {
            const T* pt = pts_of(k);
            T du, dp;
            rhs_point<MODE>(c, cur, tile_point(pt, m.ctr - 1),
                            tile_point(pt, m.ctr + 1),
                            tile_point(pt, m.ctr - HALO_X),
                            tile_point(pt, m.ctr + HALO_X), below, above, du,
                            dp);
            const int64_t o = (int64_t)z * oP + (int64_t)yo * X + x;
            if (!STAGE5) {
                a.out[o] = du;
                a.out[oV + o] = dp;
            } else {
                // w, K1, K3 and K4 of the stage-5 combination at this point
                const T* r = raw_of(k) + m.ctr_raw;
                const T h3 = a.h / T(3);
                const T k5[2] = {du, dp};
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const T k1 = r[(3 + v) * RP];
                    const T k3 = r[(5 + v) * RP];
                    const T k4 = r[(7 + v) * RP];
                    const T err = merson_err(k1, k3, k4, k5[v]);
                    mx = nan_max(mx, abs_t(err));
                    a.out[v * oV + o] = merson_update(r[v * RP], k1, k4,
                                                      k5[v], h3);
                }
            }
        }
        below = cur;
        cur = above;
    }
    if (STAGE5) block_max_store<TILE_THREADS>(mx, a.eps);
}

// The grid of a launch over part of Z planes and Yl own rows for cap
// resident blocks: the interior and all parts in chunks sized to whole
// waves, the edge part one block per tile and edge plane.
inline TileGrid stage_grid(int cap, int part, int Z, int Yl, int X) {
    if (part != PART_EDGE)
        return tile_grid(cap, part == PART_INTERIOR ? Z - 2 : Z, Yl, X);
    TileGrid g = tile_grid(cap, 1, Yl, X);
    g.grid.z = 2;
    return g;
}

// Fills the argument block of one stage; the kernels' C entries share it.
// Returns 0, or 1000 + n for bad arguments.
template <class T>
inline int stage_args(StageArgsT<T>& a, int nk, int stage5, T t, T h,
                      const T* coefs, const T* w, const T* k0, const T* k1,
                      const T* k2, T* out, T* eps, long long eps_n, int Z,
                      int Y, int X) {
    if (nk < 0 || nk > 3) return 1001;
    if (stage5 && nk != 3) return 1002;
    if (Z < 1 || Y < 1 || X < 1) return 1003;
    const int64_t V = (int64_t)Z * Y * X;
    const T* k[3] = {k0, k1, k2};
    for (int q = 0; q < RAW; ++q)
        a.plane[q] = q < 3 ? w + q * V
            : q < 3 + 2 * nk ? k[(q - 3) / 2] + ((q - 3) % 2) * V : nullptr;
    for (int q = 0; q < 3; ++q) a.hc[q] = q < nk ? h * coefs[q] : T(0);
    a.vec = copy_width(a.plane, 3 + 2 * nk, X);
    a.t = t;
    a.h = h;
    a.out = out;
    a.eps = eps;
    a.eps_n = eps_n;
    a.g = Grid{Z, Y, X};
    a.tz = 0;
    return 0;
}

}  // namespace pft
