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
// of fused_stage.cu, on a shard that holds the whole grid, so an attempt
// equals the fused_stage chain bit for bit.  pft_fused_attempt_dev reads
// (t_s, h) from the control block of the device-resident controller
// (control.cuh), the commit's slot flip being control.cu's pft_commit.
//
// What bounds it on Hopper: the bytes, as for fused_stage.  One attempt
// moves 41 float32 single-variable planes (stages 1-4: 5 + 7 + 9 + 9, the
// tail: 11).  At MR (100x100x200, 8 MB a plane) that is 328 MB, 0.098 ms at
// 3.35 TB/s; the tail launch alone moves 88 MB, 0.026 ms.  The tiled body
// (stage.cuh, tile.cuh) reads each element once per plane, apart from the
// halo and the planes around a chunk.  On the H100 an attempt takes about
// 1.75x a tensor copy of its 328 MB (PERF.md): the launches with few inputs
// are bound by the cost per point that does not scale with the bytes, the
// tail by the bytes (stage.cuh).
#include "stage.cuh"

namespace pft {

struct AttemptArgs {
    StageArgs s;           // w's planes and, for the tail, out are set per
                           // launch from the slot
    float* y2;             // (2, 3, Z, Y, X)
    const int* cur;        // slot index, 0 or 1
};

// TAIL: 0 = K of stages 1-4, 1 = the stage-5 tail (NK = 3).  DEV: the
// _dev entry, whose scalars come from the control block d.ctl and which
// returns at once once the loop has halted.
template <int MODE, int NK, int TAIL, bool DEV>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM)
fused_attempt_kernel(const Consts c, const AttemptArgs a, const ShardArgs s,
                     const DevStage d) {
    if constexpr (DEV) {
        if (d.ctl->halt) return;
    }
    const int cur = *a.cur;
    const int64_t V = a.s.g.var(), slot = 3 * V;
    StageArgs st = a.s;
    if constexpr (DEV) stage_scalars(st, d);
    const float* w = a.y2 + cur * slot;
#pragma unroll
    for (int q = 0; q < 3; ++q) st.plane[q] = w + q * V;
    if (TAIL) st.out = a.y2 + (1 - cur) * slot;
    stage_body<MODE, NK, TAIL == 1>(c, st, s);
}

// Computes the grid of a launch; with out, only stores it there, else
// launches, when a tail's grid has no more blocks than eps has slots (as
// many, for a _dev tail: the control kernel reduces every slot).
template <int MODE, int NK, int TAIL, bool DEV>
static int launch_as(const Consts& c, AttemptArgs a, const DevStage& d,
                     cudaStream_t s, TileGrid* out) {
    static int resident[MAX_DEVICES] = {};      // blocks on the card
    int cap = 0;
    const int rc = resident_blocks(fused_attempt_kernel<MODE, NK, TAIL, DEV>,
                                   stage_smem_bytes(NK), resident, cap);
    if (rc) return rc;
    const Grid& g = a.s.g;
    const TileGrid sg = stage_grid(cap, PART_ALL, g.Z, g.Y, g.X);
    if (out) {
        *out = sg;
        return 0;
    }
    const int64_t blocks = (int64_t)sg.grid.x * sg.grid.y * sg.grid.z;
    if (TAIL && (blocks > a.s.eps_n || (DEV && blocks != a.s.eps_n)))
        return 1012;
    a.s.tz = sg.tz;
    fused_attempt_kernel<MODE, NK, TAIL, DEV><<<sg.grid, TILE_THREADS,
                                                stage_smem_bytes(NK), s>>>(
        c, a, whole_grid(g.Y), d);
    return (int)cudaGetLastError();
}

template <int MODE, int NK, int TAIL>
static int launch_kernel(const Consts& c, const AttemptArgs& a,
                         const DevStage* d, cudaStream_t s, TileGrid* out) {
    return d ? launch_as<MODE, NK, TAIL, true>(c, a, *d, s, out)
             : launch_as<MODE, NK, TAIL, false>(c, a, DevStage{}, s, out);
}

template <int MODE>
static int launch_mode(const Consts& c, const AttemptArgs& a,
                       const DevStage* d, int nk, int tail, cudaStream_t s,
                       TileGrid* out) {
    if (tail) return launch_kernel<MODE, 3, 1>(c, a, d, s, out);
    if (nk == 0) return launch_kernel<MODE, 0, 0>(c, a, d, s, out);
    if (nk == 1) return launch_kernel<MODE, 1, 0>(c, a, d, s, out);
    if (nk == 2) return launch_kernel<MODE, 2, 0>(c, a, d, s, out);
    return launch_kernel<MODE, 3, 0>(c, a, d, s, out);
}

static int launch(const Consts& c, const AttemptArgs& a, int mode, int nk,
                  int tail, cudaStream_t s, TileGrid* out = nullptr,
                  const DevStage* d = nullptr) {
    switch (mode) {
        case GRADP: return launch_mode<GRADP>(c, a, d, nk, tail, s, out);
        case SIGMAP: return launch_mode<SIGMAP>(c, a, d, nk, tail, s, out);
        case TEMP: return launch_mode<TEMP>(c, a, d, nk, tail, s, out);
        case GRADP_FROZEN_U:
            return launch_mode<GRADP_FROZEN_U>(c, a, d, nk, tail, s, out);
        case SIGMAP_FROZEN_U:
            return launch_mode<SIGMAP_FROZEN_U>(c, a, d, nk, tail, s, out);
        default: return 1004;
    }
}

}  // namespace pft

using namespace pft;

extern "C" {

// One stage of a double-buffered attempt: K into out (tail = 0), or y_spec
// into slot 1 - cur of y2 and the eps partials into eps (tail = 1; out is
// not used).  consts and coefs are host arrays; every other pointer is
// device memory.  eps has eps_n slots, pft_attempt_eps_blocks of the
// launch.  Returns cudaGetLastError() after the launch; 1000 + n for bad
// arguments (1012: eps is too short for the launch's grid).
int pft_fused_attempt(const float* consts, int mode, int nk, int tail,
                      float t, float h, const float* coefs, float* y2,
                      const int* cur, const float* k0, const float* k1,
                      const float* k2, float* out, float* eps, int Z, int Y,
                      int X, void* stream, long long eps_n) {
    AttemptArgs a;
    // the planes of slot 0 set the copy width; slot 1 is 3 Z Y X floats on,
    // a multiple of it
    int bad = stage_args(a.s, nk, tail, t, h, coefs, y2, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    a.y2 = y2;
    a.cur = cur;
    return launch(*reinterpret_cast<const Consts*>(consts), a, mode, nk, tail,
                  static_cast<cudaStream_t>(stream));
}

// The _dev entry of pft_fused_attempt: t_s and h of stage `stage` (0-4)
// of the next attempt come from the control block ctl (device memory), and
// the launch returns at once once the loop has halted; coefs are the c_a.
// A tail's eps must have exactly the launch's slots.  Returns as
// pft_fused_attempt; 1013 for a bad ctl or stage.
int pft_fused_attempt_dev(const float* consts, int mode, int nk, int tail,
                          const void* ctl, int stage, const float* coefs,
                          float* y2, const int* cur, const float* k0,
                          const float* k1, const float* k2, float* out,
                          float* eps, int Z, int Y, int X, void* stream,
                          long long eps_n) {
    AttemptArgs a;
    int bad = stage_args(a.s, nk, tail, 0.0f, 0.0f, coefs, y2, k0, k1, k2,
                         out, eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 0 || stage > 4) return 1013;
    a.y2 = y2;
    a.cur = cur;
    const DevStage d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const Consts*>(consts), a, mode, nk, tail,
                  static_cast<cudaStream_t>(stream), nullptr, &d);
}

// eps partial slots of a tail launch over a (Z, Y, X) grid on the current
// device: the blocks of its grid; -1 for bad arguments or a failed query.
long long pft_attempt_eps_blocks(int mode, int Z, int Y, int X) {
    if (Z < 1 || Y < 1 || X < 1) return -1;
    AttemptArgs a{};
    a.s.g = Grid{Z, Y, X};
    TileGrid sg;
    if (launch(Consts{}, a, mode, 3, 1, nullptr, &sg)) return -1;
    return (long long)sg.grid.x * sg.grid.y * sg.grid.z;
}

}  // extern "C"
