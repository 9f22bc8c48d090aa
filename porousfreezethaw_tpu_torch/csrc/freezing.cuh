// Shared device code of the freezing-model stencil kernels
// (fused_stage.cu, fused_attempt.cu, delta_g.cu): the host-computed
// constants, the cell-local material blends, the shard options and the
// NaN-propagating block max.  How a block's planes reach shared memory and
// how a launch's grid is sized is the tile engine of tile.cuh.
//
// Layout: every field is a contiguous array (nv, Z, Y, X) of the field's
// width T (float32; float64 for the stage kernel's float64 _dev entry) with
// x fastest; plane = Y*X, variable stride = Z*Y*X.  Mirror boundaries are
// clamped indices; the temperature's z-top neighbour is a Dirichlet ghost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pft {

// Constants computed in float64 on the host (ops/cuda/stencil.py,
// StencilSpec.packed) in the field's width T: rounded once to float32, or
// kept in float64.  The order of the fields is the order of CONST_NAMES in
// stencil.py; pft_num_consts() lets the host check the count.
template <class T>
struct ConstsT {
    T h1_2, h2_2, h3_2;            // (1/h_i)^2
    T h1d2, h2d2, h3d2;            // 0.5/h_i
    T u_star, L, alpha, zeta;
    T glass_rho, ice_rho, water_rho;
    T glass_cp, ice_cp, water_cp;
    T glass_lambda, ice_lambda, water_lambda;
    T lam_p_slope, rho_p_slope, cp_p_slope;       // ice - water
    T A;                           // a / xi^2
    T B;                           // b * alpha * mu          (GradP)
    T C;                           // b sqrt(a/2)/xi * alpha * mu (SigmaP1-P)
    T p_eps0, p_eps1, eps2_3, eps3_2;
    T gamma, neg_half_gamma;       // gamma, -0.5*gamma
    T eps_reg;                     // |grad p| regularisation (1e-10)
    T top_temp1, top_temp2, phase_switch_time;
};
using Consts = ConstsT<float>;
constexpr int NUM_CONSTS = sizeof(Consts) / sizeof(float);
static_assert(sizeof(ConstsT<double>) == NUM_CONSTS * sizeof(double),
              "bad constants");

// calc_mode values (models/freezing/equation.py CalcMode)
constexpr int GRADP = 0, SIGMAP = 1, TEMP = 2;
constexpr int GRADP_FROZEN_U = 10, SIGMAP_FROZEN_U = 11;

// max that propagates NaN from either side, as jnp.maximum / torch.maximum
// do (fmaxf drops a NaN operand)
template <class T>
__device__ __forceinline__ T nan_max(T a, T b) {
    return (a > b || a != a) ? a : b;
}

// exp, sqrt and abs in the width of their argument: the float32 functions
// for float, the float64 ones (IEEE sqrt; exp within an ulp) for double
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// +, - and * in the field's width.  float32: the plain operators, which
// nvcc may contract into multiply-adds (the float32 kernels' rounding);
// float64: each operation rounded on its own (__dadd_rn, __dsub_rn and
// __dmul_rn are never contracted), as make_rhs's are, so that every
// operation of the float64 stage is correctly rounded in make_rhs's
// association.  Division and sqrt are IEEE in both.
template <class T>
__device__ __forceinline__ T add_t(T a, T b) {
    if constexpr (sizeof(T) == 4) return a + b; else return __dadd_rn(a, b);
}
template <class T>
__device__ __forceinline__ T sub_t(T a, T b) {
    if constexpr (sizeof(T) == 4) return a - b; else return __dsub_rn(a, b);
}
template <class T>
__device__ __forceinline__ T mul_t(T a, T b) {
    if constexpr (sizeof(T) == 4) return a * b; else return __dmul_rn(a, b);
}

template <class T>
__device__ __forceinline__ T blend(T p, T gl, T glass, T ice, T water) {
    return add_t(mul_t(gl, glass),
                 mul_t(sub_t(T(1), gl),
                       add_t(mul_t(p, ice), mul_t(sub_t(T(1), p), water))));
}

template <class T>
__device__ __forceinline__ T rho(const ConstsT<T>& c, T p, T gl) {
    return blend(p, gl, c.glass_rho, c.ice_rho, c.water_rho);
}
template <class T>
__device__ __forceinline__ T cp(const ConstsT<T>& c, T p, T gl) {
    return blend(p, gl, c.glass_cp, c.ice_cp, c.water_cp);
}
template <class T>
__device__ __forceinline__ T lam(const ConstsT<T>& c, T p, T gl) {
    return blend(p, gl, c.glass_lambda, c.ice_lambda, c.water_lambda);
}

template <class T>
__device__ __forceinline__ T water_indicator(const ConstsT<T>& c, T gl) {
    return nan_max(sub_t(T(1), mul_t(c.zeta, gl)), T(0));
}

template <class T>
__device__ __forceinline__ T sshape(const ConstsT<T>& c, T x) {
    T xs = sub_t(x, c.p_eps0);
    T mid = mul_t(mul_t(xs, xs), sub_t(c.eps2_3, mul_t(c.eps3_2, xs)));
    return x <= c.p_eps0 ? T(0) : (x >= c.p_eps1 ? T(1) : mid);
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
template <int THREADS, class T>
__device__ __forceinline__ void block_max_store(T m, T* out) {
    __shared__ T warp_max[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
    int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
        T r = warp_max[0];
        for (int i = 1; i < THREADS / 32; ++i) r = nan_max(r, warp_max[i]);
        int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x;
        out[b] = r;
    }
}

}  // namespace pft
