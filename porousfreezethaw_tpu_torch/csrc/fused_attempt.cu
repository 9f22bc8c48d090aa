// Double-buffered Merson attempt of the freezing model (classic form).
//
// Replaces the Pallas kernel FusedAttempt.build_call
// (porousfreezethaw_tpu/ops/pallas/stencil.py:1401-1518, pallas_call at
// :1504).  The state is one contiguous float32 buffer y2 of shape
// (2, 3, Z, Y, X) and a slot index cur, a one-element int32 array in device
// memory that the kernel reads itself:
//
//   stages 1-4   read slot cur, write a 2-variable K (u, p);
//   stage-5 tail reads slot cur, writes (u, p) of y_spec into slot 1 - cur
//                and one eps partial per block.
//
// Accepting an attempt is then a flip of cur on the device: no copy and no
// host sync, and every launch of every attempt sees the same pointers, which
// a later CUDA-graph capture of the attempt needs.  gl is static, so pack
// fills both slots with it once and the tail never writes it.  The TPU
// kernel moved the state through input/output aliasing and carried a zero
// gl row in its K buffers; both go here (the eps max is unchanged: those
// rows are exactly zero).  The stage is stage_body of stage.cuh, the code
// of fused_stage.cu, so an attempt equals the fused_stage chain bit for bit.
//
// What bounds it on Hopper: memory traffic, as for fused_stage.  One
// attempt moves 41 float32 single-variable planes (stages 1-4: 5 + 7 + 9 + 9,
// the tail: 11).  At MR (100x100x200, 8 MB a plane) that is 328 MB, 0.098 ms
// at 3.35 TB/s; the tail launch alone moves 88 MB, 0.026 ms.
#include "stage.cuh"

namespace pft {

struct AttemptArgs {
    StageArgs s;           // w and, for the tail, out are set per launch
    float* y2;             // (2, 3, Z, Y, X)
    const int* cur;        // slot index, 0 or 1
};

template <int MODE, bool TAIL>
__global__ void __launch_bounds__(BX * BY)
fused_attempt_kernel(const Consts c, const AttemptArgs a) {
    const int cur = *a.cur;
    const int64_t slot = 3 * a.s.g.var();
    StageArgs s = a.s;
    s.w = a.y2 + cur * slot;
    if (TAIL) s.out = a.y2 + (1 - cur) * slot;
    stage_body<MODE, TAIL>(c, s);
}

template <int MODE>
static void launch_mode(const Consts& c, const AttemptArgs& a, bool tail,
                        cudaStream_t s) {
    dim3 grid = launch_grid(a.s.g.Z, a.s.g.Y, a.s.g.X), block(BX, BY);
    if (tail)
        fused_attempt_kernel<MODE, true><<<grid, block, 0, s>>>(c, a);
    else
        fused_attempt_kernel<MODE, false><<<grid, block, 0, s>>>(c, a);
}

}  // namespace pft

using namespace pft;

extern "C" {

// One stage of a double-buffered attempt: K into out (tail = 0), or y_spec
// into slot 1 - cur of y2 and the eps partials into eps (tail = 1; out is
// not used).  consts and coefs are host arrays; every other pointer is
// device memory.  Returns cudaGetLastError() after the launch; 1000 + n for
// bad arguments.
int pft_fused_attempt(const float* consts, int mode, int nk, int tail,
                      float t, float h, const float* coefs, float* y2,
                      const int* cur, const float* k0, const float* k1,
                      const float* k2, float* out, float* eps, int Z, int Y,
                      int X, void* stream) {
    AttemptArgs a;
    int bad = stage_args(a.s, nk, tail, t, h, coefs, nullptr, k0, k1, k2,
                         out, eps, Z, Y, X);
    if (bad) return bad;
    a.y2 = y2;
    a.cur = cur;
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

}  // extern "C"
