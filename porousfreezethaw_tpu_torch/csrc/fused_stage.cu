// Fused Merson stage + 7-point stencil of the freezing model (classic form).
//
// Replaces the Pallas kernel make_fused_stage -> build_call_pipe
// (porousfreezethaw_tpu/ops/pallas/stencil.py:662-748, pallas_call at :737;
// arithmetic in _core :434-492 and _compute_rhs :142-192).  The stage itself
// is stage_body of stage.cuh: K = f(t_s, w + sum_a (h*c_a) K_a), or with
// STAGE5 the Merson tail (y_spec and the eps partials).
//
// What bounds it on Hopper: memory traffic.  A classic attempt moves about
// 47 float32 single-variable planes (w read per stage, every K input, the K
// outputs, y_spec) against a few hundred flops per cell, far below the
// card's flop/byte balance.  This first design keeps the traffic to one
// pass over each input per stage: one thread per (x, y) column, x fastest
// so a warp loads 128 contiguous bytes, marching ZCHUNK planes with the
// z-1/z/z+1 combined values held in registers; in-plane neighbours are
// recomputed from global memory and served mostly by L1/L2.  Shared-memory
// tiling, TMA and whole-attempt fusion are later work.
//
// The shard entry pft_fused_stage_shard is stage_body with SHARD (see
// stage.cuh): K1s, the stage on one shard of a device mesh (Pallas
// shard_ghosts and plane_rows/row_window, stencil.py:401-465, :697-703), and
// K3, its interior and edge parts (make_fused_stage -> build_call,
// stencil.py:494-660, pallas_call at :642): the interior pass covers planes
// [1, Z-1) and reads no ghost, so the halo copies overlap it; the edge pass
// writes planes 0 and Z-1 into the interior pass's output and its eps
// partials into the slots after the interior's.  The single-device
// instantiation above is unchanged.  The same memory-bound design; a shard
// of zl planes reads its nk+1 inputs plus 2 ghost planes of each.
#include "stage.cuh"

namespace pft {

template <int MODE, bool STAGE5>
__global__ void __launch_bounds__(BX * BY)
fused_stage_kernel(const Consts c, const StageArgs a) {
    stage_body<MODE, STAGE5>(c, a);
}

template <int MODE>
static void launch_mode(const Consts& c, const StageArgs& a, bool stage5,
                        cudaStream_t s) {
    dim3 grid = launch_grid(a.g.Z, a.g.Y, a.g.X), block(BX, BY);
    if (stage5)
        fused_stage_kernel<MODE, true><<<grid, block, 0, s>>>(c, a);
    else
        fused_stage_kernel<MODE, false><<<grid, block, 0, s>>>(c, a);
}

template <int MODE, bool STAGE5>
__global__ void __launch_bounds__(BX * BY)
fused_stage_shard_kernel(const Consts c, const StageArgs a,
                         const ShardArgs s) {
    stage_body<MODE, STAGE5, true>(c, a, s);
}

template <int MODE>
static void launch_shard_mode(const Consts& c, const StageArgs& a,
                              const ShardArgs& sa, bool stage5,
                              cudaStream_t s) {
    dim3 grid = shard_grid(sa.part, a.g.Z, sa.Yl, a.g.X), block(BX, BY);
    if (stage5)
        fused_stage_shard_kernel<MODE, true><<<grid, block, 0, s>>>(c, a, sa);
    else
        fused_stage_shard_kernel<MODE, false><<<grid, block, 0, s>>>(c, a, sa);
}

}  // namespace pft

using namespace pft;

extern "C" {

int pft_num_consts(void) { return NUM_CONSTS; }

long long pft_eps_blocks(int Z, int Y, int X) {
    dim3 g = launch_grid(Z, Y, X);
    return (long long)g.x * g.y * g.z;
}

const char* pft_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// K (or y_spec + eps partials with stage5) of one classic Merson stage.
// consts and coefs are host arrays; every other pointer is device memory.
// Returns cudaGetLastError() after the launch; 1000 + n for bad arguments.
int pft_fused_stage(const float* consts, int mode, int nk, int stage5,
                    float t, float h, const float* coefs, const float* w,
                    const float* k0, const float* k1, const float* k2,
                    float* out, float* eps, int Z, int Y, int X,
                    void* stream) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, t, h, coefs, w, k0, k1, k2, out,
                         eps, Z, Y, X);
    if (bad) return bad;
    Consts c = *reinterpret_cast<const Consts*>(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GRADP: launch_mode<GRADP>(c, a, stage5, s); break;
        case SIGMAP: launch_mode<SIGMAP>(c, a, stage5, s); break;
        case TEMP: launch_mode<TEMP>(c, a, stage5, s); break;
        case GRADP_FROZEN_U: launch_mode<GRADP_FROZEN_U>(c, a, stage5, s); break;
        case SIGMAP_FROZEN_U: launch_mode<SIGMAP_FROZEN_U>(c, a, stage5, s); break;
        default: return 1004;
    }
    return (int)cudaGetLastError();
}

// K1s/K3: the stage on one shard.  w and k* are (nv, Z, Y, X) with the
// shard's own rows [r0, r0 + Yl); glo/ghi are the (3 + 2 nk, Y, X) ghost
// stacks (unused by the interior part); out is (2, Z, Yl, X) and eps points
// at this launch's first partial slot.  part: 0 all, 1 interior, 2 edge.
int pft_fused_stage_shard(const float* consts, int mode, int nk, int stage5,
                          float t, float h, const float* coefs,
                          const float* w, const float* k0, const float* k1,
                          const float* k2, float* out, float* eps, int Z,
                          int Y, int X, void* stream, const float* glo,
                          const float* ghi, int part, int r0, int Yl, int y0,
                          int Yg) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, t, h, coefs, w, k0, k1, k2, out,
                         eps, Z, Y, X);
    if (bad) return bad;
    ShardArgs sa{glo, ghi, part, r0, Yl, y0, Yg, 0};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    Consts c = *reinterpret_cast<const Consts*>(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GRADP: launch_shard_mode<GRADP>(c, a, sa, stage5, s); break;
        case SIGMAP: launch_shard_mode<SIGMAP>(c, a, sa, stage5, s); break;
        case TEMP: launch_shard_mode<TEMP>(c, a, sa, stage5, s); break;
        case GRADP_FROZEN_U:
            launch_shard_mode<GRADP_FROZEN_U>(c, a, sa, stage5, s); break;
        case SIGMAP_FROZEN_U:
            launch_shard_mode<SIGMAP_FROZEN_U>(c, a, sa, stage5, s); break;
        default: return 1004;
    }
    return (int)cudaGetLastError();
}

// eps partial slots of one shard launch: the blocks of its grid
long long pft_shard_eps_blocks(int part, int Z, int Yl, int X) {
    dim3 g = shard_grid(part, Z, Yl, X);
    return (long long)g.x * g.y * g.z;
}

}  // extern "C"
