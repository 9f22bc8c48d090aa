// Shared device code of the freezing-model stencil kernels
// (fused_stage.cu, fused_attempt.cu, delta_g.cu): the host-computed
// constants, the cell-local material blends, the shard options and the
// NaN-propagating block max.  How a block's planes reach shared memory and
// how a launch's grid is sized is the tile engine of tile.cuh.
//
// Layout: every field is a contiguous float32 array (nv, Z, Y, X) with x
// fastest; plane = Y*X, variable stride = Z*Y*X.  Mirror boundaries are
// clamped indices; the temperature's z-top neighbour is a Dirichlet ghost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pft {

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

// The shape of a launch's input planes.
struct Grid {
    int Z, Y, X;
    __host__ __device__ int64_t plane() const { return (int64_t)Y * X; }
    __host__ __device__ int64_t var() const { return (int64_t)Z * Y * X; }
};

// The shard options of the stage and delta kernels (stage.cuh, delta_g.cu):
// ghost stacks, the z range and the y window.  A single-device launch is a
// shard that holds the whole grid: no ghost stacks, own rows [0, Y), is_top.
struct ShardArgs {
    const float* glo;      // ghost stack below plane 0, (3 + 2 nk, Y, X):
    const float* ghi;      // w's 3 planes, then each K's (u, p); above Z-1
    int part;              // planes: 0 all, 1 interior [1, Z-1), 2 edge 0, Z-1
                           // (stage.cuh; the delta kernel takes all)
    int r0, Yl;            // own rows [r0, r0 + Yl) of the Y input rows
    int y0, Yg;            // global row of own row 0, global Y
    int is_top;            // the Dirichlet overwrites of the plane above Z-1
                           // (the stage's by-value shard entry passes 0:
                           // its ghi holds the Dirichlet top of the top
                           // shard; its _dev entry passes the shard's)
};

constexpr int PART_ALL = 0, PART_INTERIOR = 1, PART_EDGE = 2;

// The ShardArgs of a single-device launch over Y rows
inline ShardArgs whole_grid(int Y) {
    return ShardArgs{nullptr, nullptr, PART_ALL, 0, Y, 0, Y, 1};
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

// NaN-propagating max over the block of THREADS threads (a multiple of 32);
// thread 0 writes it to out[block].
template <int THREADS>
__device__ __forceinline__ void block_max_store(float m, float* out) {
    __shared__ float warp_max[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
    int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
        float r = warp_max[0];
        for (int i = 1; i < THREADS / 32; ++i) r = nan_max(r, warp_max[i]);
        int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x;
        out[b] = r;
    }
}

}  // namespace pft
