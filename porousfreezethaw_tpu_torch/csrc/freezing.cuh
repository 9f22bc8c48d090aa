// Shared device code of the freezing-model stencil kernels
// (fused_stage.cu, fused_attempt.cu, delta_g.cu): the host-computed
// constants, the cell-local material blends, the launch geometry and the
// NaN-propagating block max.
//
// Layout: every field is a contiguous float32 array (nv, Z, Y, X) with x
// fastest; plane = Y*X, variable stride = Z*Y*X.  One thread owns one
// (x, y) column and marches over ZCHUNK planes of it, keeping the z-1, z and
// z+1 values of the combined fields in registers; the four in-plane
// neighbours are read from global memory (L1/L2 hits for the most part).
// Mirror boundaries are clamped indices; the temperature's z-top neighbour
// is a Dirichlet ghost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pft {

// Block shape and z-chunk; the host side sizes the eps-partials buffer with
// pft_eps_blocks(), which uses the same numbers.
constexpr int BX = 32;
constexpr int BY = 4;
constexpr int ZCHUNK = 8;

// Constants computed in float64 on the host (ops/cuda/stencil.py,
// StencilSpec.packed) and rounded once to float32.  The order of the fields
// is the order of CONST_NAMES in stencil.py; pft_num_consts() lets the host
// check the count.
struct Consts {
    float h1_2, h2_2, h3_2;        // (1/h_i)^2
    float h1d2, h2d2, h3d2;        // 0.5/h_i
    float u_star, L, alpha, zeta;
    float glass_rho, ice_rho, water_rho;
    float glass_cp, ice_cp, water_cp;
    float glass_lambda, ice_lambda, water_lambda;
    float lam_p_slope, rho_p_slope, cp_p_slope;   // ice - water
    float A;                       // a / xi^2
    float B;                       // b * alpha * mu          (GradP)
    float C;                       // b sqrt(a/2)/xi * alpha * mu (SigmaP1-P)
    float p_eps0, p_eps1, eps2_3, eps3_2;
    float gamma, neg_half_gamma;   // gamma, -0.5*gamma
    float eps_reg;                 // |grad p| regularisation (1e-10)
    float top_temp1, top_temp2, phase_switch_time;
};
constexpr int NUM_CONSTS = sizeof(Consts) / sizeof(float);

// calc_mode values (models/freezing/equation.py CalcMode)
constexpr int GRADP = 0, SIGMAP = 1, TEMP = 2;
constexpr int GRADP_FROZEN_U = 10, SIGMAP_FROZEN_U = 11;

// max that propagates NaN from either side, as jnp.maximum / torch.maximum
// do (fmaxf drops a NaN operand)
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float blend(float p, float gl, float glass,
                                       float ice, float water) {
    return gl * glass + (1.0f - gl) * (p * ice + (1.0f - p) * water);
}

__device__ __forceinline__ float rho(const Consts& c, float p, float gl) {
    return blend(p, gl, c.glass_rho, c.ice_rho, c.water_rho);
}
__device__ __forceinline__ float cp(const Consts& c, float p, float gl) {
    return blend(p, gl, c.glass_cp, c.ice_cp, c.water_cp);
}
__device__ __forceinline__ float lam(const Consts& c, float p, float gl) {
    return blend(p, gl, c.glass_lambda, c.ice_lambda, c.water_lambda);
}

__device__ __forceinline__ float water_indicator(const Consts& c, float gl) {
    return nan_max(1.0f - c.zeta * gl, 0.0f);
}

__device__ __forceinline__ float sshape(const Consts& c, float x) {
    float xs = x - c.p_eps0;
    float mid = xs * xs * (c.eps2_3 - c.eps3_2 * xs);
    return x <= c.p_eps0 ? 0.0f : (x >= c.p_eps1 ? 1.0f : mid);
}

// Launch geometry shared by the kernels.
struct Grid {
    int Z, Y, X;
    __host__ __device__ int64_t plane() const { return (int64_t)Y * X; }
    __host__ __device__ int64_t var() const { return (int64_t)Z * Y * X; }
};

inline dim3 launch_grid(int Z, int Y, int X) {
    return dim3((X + BX - 1) / BX, (Y + BY - 1) / BY,
                (Z + ZCHUNK - 1) / ZCHUNK);
}

// The shard options of the stage and delta kernels (SHARD in stage.cuh and
// delta_g.cu): ghost stacks, the z range and the y window.
struct ShardArgs {
    const float* glo;      // ghost stack below plane 0, (3 + 2 nk, Y, X):
    const float* ghi;      // w's 3 planes, then each K's (u, p); above Z-1
    int part;              // planes: 0 all, 1 interior [1, Z-1), 2 edge 0, Z-1
    int r0, Yl;            // own rows [r0, r0 + Yl) of the Y input rows
    int y0, Yg;            // global row of own row 0, global Y
    int is_top;            // delta_g.cu: the shard holds the global top
};

constexpr int PART_ALL = 0, PART_INTERIOR = 1, PART_EDGE = 2;

// The planes [z_begin, z_end) of block z-index bz for a launch over part;
// the edge part has two blocks in z, plane 0 and plane Z-1.
__device__ __forceinline__ void part_planes(int part, int Z, int bz,
                                            int& z_begin, int& z_end) {
    if (part == PART_EDGE) {
        z_begin = bz == 0 ? 0 : Z - 1;
        z_end = z_begin + 1;
        return;
    }
    const int lo = part == PART_INTERIOR ? 1 : 0;
    const int hi = part == PART_INTERIOR ? Z - 1 : Z;
    z_begin = lo + bz * ZCHUNK;
    z_end = min(z_begin + ZCHUNK, hi);
}

inline dim3 shard_grid(int part, int Z, int Yl, int X) {
    dim3 g = launch_grid(part == PART_INTERIOR ? Z - 2 : Z, Yl, X);
    if (part == PART_EDGE) g.z = 2;
    return g;
}

// Checks the shard options against the input shape (Z, Y, X); returns 0 or
// 1000 + n.
inline int shard_check(const ShardArgs& s, int Z, int Y) {
    if (s.part < PART_ALL || s.part > PART_EDGE) return 1006;
    if (s.part != PART_ALL && Z < 3) return 1007;
    if (s.part != PART_INTERIOR && (!s.glo || !s.ghi)) return 1008;
    if (s.Yl < 1 || s.r0 < 0 || s.r0 + s.Yl > Y) return 1009;
    // a row that is not a global edge needs its neighbour row in the input
    if ((s.y0 > 0 && s.r0 < 1) || (s.y0 + s.Yl < s.Yg && s.r0 + s.Yl >= Y))
        return 1010;
    if (s.y0 < 0 || s.y0 + s.Yl > s.Yg) return 1011;
    return 0;
}

// NaN-propagating max over the block; thread 0 writes it to out[block].
__device__ __forceinline__ void block_max_store(float m, float* out) {
    __shared__ float warp_max[BX * BY / 32];
    for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
    int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
        float r = warp_max[0];
        for (int i = 1; i < BX * BY / 32; ++i) r = nan_max(r, warp_max[i]);
        int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x;
        out[b] = r;
    }
}

}  // namespace pft
