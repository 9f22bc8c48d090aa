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
#pragma once

#include "control.cuh"
#include "tile.cuh"

namespace pft {

struct Pt { float u, p, gl; };

constexpr int NPT = 3;     // assembled planes: u, p, gl
// raw planes in the ring: RING - 2 in flight while a plane is computed, as
// the buffer of the computed plane is kept for the stage-5 tail
constexpr int RING = 4;
static_assert(RING >= 3, "bad ring");

struct StageArgs {
    const float* plane[RAW];  // the raw input planes at z = 0: w's u, p, gl
                              // (3, Z, Y, X), then the (u, p) of each K
                              // input, each (2, Z, Y, X)
    float hc[3];           // h*c_a, formed in float32
    float t, h;
    float* out;            // K (2, Z, Yl, X), or y_spec with STAGE5
    float* eps;            // per-block partial max (STAGE5)
    int64_t eps_n;         // its slots
    Grid g;
    int vec;               // floats per copy: 4, 2 or 1 (alignment of rows)
    int tz;                // planes per block (the chunk)
};

constexpr int stage_smem_bytes(int nk) {
    return tile_smem_bytes<NPT, RING>(nk);
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

// aux = w + sum_a (h c_a) K_a of the raw values r of one point, accumulated
// in the Pallas order (stencil.py _core).  The multiply-adds are explicit,
// so every call site rounds alike.
template <int NK>
__device__ __forceinline__ Pt assemble(const StageArgs& a, const float* r) {
    float u = r[0], p = r[1];
#pragma unroll
    for (int q = 0; q < NK; ++q) {
        u = __fmaf_rn(a.hc[q], r[3 + 2 * q], u);
        p = __fmaf_rn(a.hc[q], r[4 + 2 * q], p);
    }
    return Pt{u, p, r[2]};
}

// The point at place i of the raw buffer raw
template <int NK>
__device__ __forceinline__ Pt raw_point(const StageArgs& a, const float* raw,
                                        int i) {
    float r[3 + 2 * NK];
    raw_values<NK>(raw, i, r);
    return assemble<NK>(a, r);
}

__device__ __forceinline__ Pt tile_point(const float* pt, int cell) {
    return Pt{pt[cell], pt[HALO_CELLS + cell], pt[2 * HALO_CELLS + cell]};
}

__device__ __forceinline__ void store_point(float* pt, int cell,
                                            const Pt& v) {
    pt[cell] = v.u;
    pt[HALO_CELLS + cell] = v.p;
    pt[2 * HALO_CELLS + cell] = v.gl;
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
template <int MODE, int NK, bool STAGE5>
__device__ __forceinline__ void stage_body(const Consts& c,
                                           const StageArgs& a,
                                           const ShardArgs& s) {
    constexpr int NR = 3 + 2 * NK;
    extern __shared__ __align__(16) float smem[];
    __shared__ int rowoff[ROWS];
    // RING raw planes, then the assembled planes of two consecutive z
    float* const raw = smem;
    float* const pts = smem + RING * NR * RAW_PLANE;
    const int X = a.g.X, Z = a.g.Z;
    const int x0 = blockIdx.x * TILE_X, yo0 = blockIdx.y * TILE_Y;
    int z0, z1;
    part_planes(s.part, Z, a.tz, blockIdx.z, z0, z1);
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
    // buffer k % RING and, assembled, in pts[k % 2].  The raw buffer of
    // plane k is refilled after the barrier that follows its computation
    // (the stage-5 tail reads it then): RING - 2 planes are in flight while
    // a plane is computed.
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
    Pt below{}, cur{};
    if (point) {
        below = raw_point<NK>(a, raw_of(0), m.ctr_raw);
        cur = raw_point<NK>(a, raw_of(1), m.ctr_raw);
        store_point(pts_of(1), m.ctr, cur);
    }
    if (m.halo >= 0)
        store_point(pts_of(1), m.halo,
                    raw_point<NK>(a, raw_of(1), m.halo_raw));
    float mx = 0.0f;
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
        Pt above{};
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
            const float* pt = pts_of(k);
            float du, dp;
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
                const float* r = raw_of(k) + m.ctr_raw;
                const float h3 = a.h / 3.0f;
                const float k5[2] = {du, dp};
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const float k1 = r[(3 + v) * RAW_PLANE];
                    const float k3 = r[(5 + v) * RAW_PLANE];
                    const float k4 = r[(7 + v) * RAW_PLANE];
                    float err = 0.2f * k1 - 0.9f * k3 + 0.8f * k4
                                - 0.1f * k5[v];
                    mx = nan_max(mx, fabsf(err));
                    a.out[v * oV + o] = r[v * RAW_PLANE]
                                        + h3 * (0.5f * (k1 + k5[v])
                                                + 2.0f * k4);
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
inline int stage_args(StageArgs& a, int nk, int stage5, float t, float h,
                      const float* coefs, const float* w, const float* k0,
                      const float* k1, const float* k2, float* out,
                      float* eps, long long eps_n, int Z, int Y, int X) {
    if (nk < 0 || nk > 3) return 1001;
    if (stage5 && nk != 3) return 1002;
    if (Z < 1 || Y < 1 || X < 1) return 1003;
    const int64_t V = (int64_t)Z * Y * X;
    const float* k[3] = {k0, k1, k2};
    for (int q = 0; q < RAW; ++q)
        a.plane[q] = q < 3 ? w + q * V
            : q < 3 + 2 * nk ? k[(q - 3) / 2] + ((q - 3) % 2) * V : nullptr;
    for (int q = 0; q < 3; ++q) a.hc[q] = q < nk ? h * coefs[q] : 0.0f;
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
