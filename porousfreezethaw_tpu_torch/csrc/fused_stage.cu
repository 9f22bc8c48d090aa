// Fused Merson stage + 7-point stencil of the freezing model (classic form).
//
// Replaces the Pallas kernel make_fused_stage -> build_call_pipe
// (porousfreezethaw_tpu/ops/pallas/stencil.py:662-748, pallas_call at :737;
// arithmetic in _core :434-492 and _compute_rhs :142-192).  The stage itself
// is stage_body of stage.cuh: K = f(t_s, w + sum_a (h*c_a) K_a), or with
// STAGE5 the Merson tail (y_spec and the eps partials).
//
// One kernel serves both entries.  The shard entry pft_fused_stage_shard is
// K1s, the stage on one shard of a device mesh (Pallas shard_ghosts and
// plane_rows/row_window, stencil.py:401-465, :697-703), and K3, its interior
// and edge parts (make_fused_stage -> build_call, stencil.py:494-660,
// pallas_call at :642): the interior pass covers planes [1, Z-1) and reads
// no ghost, so the halo copies overlap it; the edge pass writes planes 0
// and Z-1 into the interior pass's output and its eps partials into the
// slots after the interior's.  The single-device entry pft_fused_stage (K1)
// is the same kernel on a shard that holds the whole grid (stage.cuh), so
// ptxas compiles one body for K1, K1s and K3, and a sharded stage equals
// the single-device stage bit for bit.  pft_fused_stage_dev is the
// single-device entry with its scalars (t_s, h) read from the control block
// of the device-resident controller (control.cuh, control.cu): the same
// kernel template with DEV set, whose blocks return at once once the loop
// has halted, so that a CUDA graph of attempts needs no host scalar.
// pft_fused_stage_shard_dev joins the two: the shard entry of the
// device-resident loop on a mesh (parallel/fused.py), whose top shard has
// the Dirichlet top decided by the kernel on t_s (is_top, as a
// single-device launch decides it) where the by-value shard entry takes it
// in the content of its ghost stack.
//
// What bounds it on Hopper: the bytes, 3 + 2 nk planes read and 2 written
// per launch (40 MB at MR for nk = 0, 0.012 ms at 3.35 TB/s; a shard's
// launch also reads the 2 ghost planes of each input), against about 160
// float32 operations per point.  The design (stage.cuh, tile.cuh) reads
// each input element from device memory once per plane, apart from the
// tile's halo and the planes around a chunk, and sizes the grid to whole
// waves of the card.  At nk = 0, K1's launch on the main path, the cost per
// point that does not scale with the bytes dominates: about 2.1x a tensor
// copy of its bytes on the H100 (stage.cuh, PERF.md).  K3's edge pass, two
// planes, takes about twice one launch's floor.
//
// The float64 instantiation (T = double: pft_fused_stage_dev64, the _dev
// entry alone) replaces no Pallas kernel: it is the f64 path's attempt,
// which the JAX package and, before it, the port computed with the plain
// right-hand side (models/freezing/equation.py make_rhs over
// solvers/merson.py merson_stages: about 190 PyTorch kernels a stage, each
// a pass over the fields in device memory).  It runs that right-hand side's
// arithmetic in float64 throughout (stage.cuh): constants kept in float64
// on the host, the float64 stage time and scale of the control block, the
// top decided on the float64 t_s, float64 eps partials (the control
// kernel's eps_f64).  What bounds it: the bytes, 5, 7, 9, 9 and 11 double
// planes for the five stages, 656 MB an attempt at MR, 0.196 ms at 3.35
// TB/s; and near them the FP64 pipe: about 160 operations a point with 3
// IEEE divisions and a square root, each a sequence of some 10 FP64
// instructions, about 0.1-0.15 ms an attempt at MR at 34 TFLOP/s.  The
// design targets the bytes; the FP64 work per point is make_rhs's own,
// each +, - and * rounded on its own (no multiply-adds, a few more FP64
// instructions), so that each operation of the f64 path is correctly
// rounded in make_rhs's association; its step sequence is sensitive to
// the last bits:
//
// * the tile engine in double: a raw row of 54 doubles, copies of 16 bytes
//   (2 doubles; 1 where a row is not 16-byte aligned), the ring of 4 planes
//   and the two assembled planes sized from sizeof(T): 216.6 KB of shared
//   memory at nk = 3, within the 227 KB of one block;
// * one block of 512 threads an SM (BLOCKS_PER_SM_T), so that a thread has
//   128 registers for values held in register pairs; each block keeps two
//   planes of copies in flight (93 KB at nk = 3), more than the bytes in
//   flight that an SM needs to draw its share of the card's bandwidth;
// * the grid in whole waves of the card's 132 resident blocks, as in
//   float32, and the blocks of an idle attempt return at once on halt.
#include "stage.cuh"

namespace pft {

// TAIL: 0 = K, 1 = the stage-5 tail (y_spec and eps); the tail takes
// NK = 3 (K1, K3, K4).  DEV: the _dev entry, whose scalars come from the
// control block d.ctl and which returns at once once the loop has halted.
// T: the field's width, float, or double for the _dev entry alone.
template <int MODE, int NK, int TAIL, bool DEV, class T>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM_T<T>)
fused_stage_kernel(const ConstsT<T> c, const StageArgsT<T> a,
                   const ShardArgs s, const DevStageT<T> d) {
    if constexpr (DEV) {
        if (d.ctl->halt) return;
        StageArgsT<T> b = a;
        stage_scalars(b, d);
        stage_body<MODE, NK, TAIL == 1>(c, b, s);
    } else {
        stage_body<MODE, NK, TAIL == 1>(c, a, s);
    }
}

// Computes the grid of a launch; with out, only stores it there, else
// launches, when a tail's grid has no more blocks than eps has slots (as
// many, for a _dev tail: the control kernel reduces every slot).
template <int MODE, int NK, int TAIL, bool DEV, class T>
static int launch_as(const ConstsT<T>& c, StageArgsT<T> a,
                     const ShardArgs& sa, const DevStageT<T>& d,
                     cudaStream_t s, TileGrid* out) {
    static int resident[MAX_DEVICES] = {};      // blocks on the card
    int cap = 0;
    const int rc = resident_blocks(fused_stage_kernel<MODE, NK, TAIL, DEV, T>,
                                   stage_smem_bytes<T>(NK), resident, cap);
    if (rc) return rc;
    const TileGrid sg = stage_grid(cap, sa.part, a.g.Z, sa.Yl, a.g.X);
    if (out) {
        *out = sg;
        return 0;
    }
    const int64_t blocks = (int64_t)sg.grid.x * sg.grid.y * sg.grid.z;
    if (TAIL && (blocks > a.eps_n || (DEV && blocks != a.eps_n)))
        return 1012;
    a.tz = sg.tz;
    fused_stage_kernel<MODE, NK, TAIL, DEV, T><<<sg.grid, TILE_THREADS,
                                                 stage_smem_bytes<T>(NK),
                                                 s>>>(c, a, sa, d);
    return (int)cudaGetLastError();
}

// The float32 kernel has both entries; the float64 one the _dev entry
// alone (1014 without a DevStage)
template <int MODE, int NK, int TAIL, class T>
static int launch_kernel(const ConstsT<T>& c, const StageArgsT<T>& a,
                         const ShardArgs& sa, const DevStageT<T>* d,
                         cudaStream_t s, TileGrid* out) {
    if constexpr (sizeof(T) == 8)
        return d ? launch_as<MODE, NK, TAIL, true>(c, a, sa, *d, s, out)
                 : 1014;
    else
        return d ? launch_as<MODE, NK, TAIL, true>(c, a, sa, *d, s, out)
                 : launch_as<MODE, NK, TAIL, false>(c, a, sa, DevStageT<T>{},
                                                    s, out);
}

template <int MODE, class T>
static int launch_mode(const ConstsT<T>& c, const StageArgsT<T>& a,
                       const ShardArgs& sa, const DevStageT<T>* d, int nk,
                       int tail, cudaStream_t s, TileGrid* out) {
    if (tail) return launch_kernel<MODE, 3, 1>(c, a, sa, d, s, out);
    if (nk == 0) return launch_kernel<MODE, 0, 0>(c, a, sa, d, s, out);
    if (nk == 1) return launch_kernel<MODE, 1, 0>(c, a, sa, d, s, out);
    if (nk == 2) return launch_kernel<MODE, 2, 0>(c, a, sa, d, s, out);
    return launch_kernel<MODE, 3, 0>(c, a, sa, d, s, out);
}

template <class T>
static int launch(const ConstsT<T>& c, const StageArgsT<T>& a,
                  const ShardArgs& sa, int mode, int nk, int tail,
                  cudaStream_t s, TileGrid* out = nullptr,
                  const DevStageT<T>* d = nullptr) {
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

}  // namespace pft

using namespace pft;

extern "C" {

int pft_num_consts(void) { return NUM_CONSTS; }

const char* pft_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// K (or y_spec + eps partials with stage5) of one classic Merson stage.
// consts and coefs are host arrays; every other pointer is device memory.
// eps has eps_n slots, pft_stage_eps_blocks of the launch.  Returns
// cudaGetLastError() after the launch; 1000 + n for bad arguments (1012:
// eps is too short for the launch's grid).
int pft_fused_stage(const float* consts, int mode, int nk, int stage5,
                    float t, float h, const float* coefs, const float* w,
                    const float* k0, const float* k1, const float* k2,
                    float* out, float* eps, int Z, int Y, int X,
                    void* stream, long long eps_n) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, t, h, coefs, w, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    return launch(*reinterpret_cast<const Consts*>(consts), a, whole_grid(Y),
                  mode, nk, stage5, static_cast<cudaStream_t>(stream));
}

// The _dev entry of pft_fused_stage: t_s and h of stage `stage` (0-4) of
// the next attempt come from the control block ctl (device memory), and
// the launch returns at once once the loop has halted; coefs are the c_a,
// from which the kernel forms h*c_a as the host does for pft_fused_stage.
// A tail's eps must have exactly the launch's slots.  Returns as
// pft_fused_stage; 1013 for a bad ctl or stage.
int pft_fused_stage_dev(const float* consts, int mode, int nk, int stage5,
                        const void* ctl, int stage, const float* coefs,
                        const float* w, const float* k0, const float* k1,
                        const float* k2, float* out, float* eps, int Z,
                        int Y, int X, void* stream, long long eps_n) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, 0.0f, 0.0f, coefs, w, k0, k1, k2,
                         out, eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 0 || stage > 4) return 1013;
    const DevStage d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const Consts*>(consts), a, whole_grid(Y),
                  mode, nk, stage5, static_cast<cudaStream_t>(stream),
                  nullptr, &d);
}

// K1s/K3: the stage on one shard.  w and k* are (nv, Z, Y, X) with the
// shard's own rows [r0, r0 + Yl); glo/ghi are the (3 + 2 nk, Y, X) ghost
// stacks (unused by the interior part); out is (2, Z, Yl, X) and eps points
// at this launch's first partial slot.  part: 0 all, 1 interior, 2 edge.
int pft_fused_stage_shard(const float* consts, int mode, int nk, int stage5,
                          float t, float h, const float* coefs,
                          const float* w, const float* k0, const float* k1,
                          const float* k2, float* out, float* eps, int Z,
                          int Y, int X, void* stream, long long eps_n,
                          const float* glo, const float* ghi, int part,
                          int r0, int Yl, int y0, int Yg) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, t, h, coefs, w, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    // the Dirichlet top of the top shard is in ghi
    ShardArgs sa{glo, ghi, part, r0, Yl, y0, Yg, 0};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    a.vec = ghost_width(a.vec, glo, ghi);
    return launch(*reinterpret_cast<const Consts*>(consts), a, sa, mode, nk,
                  stage5, static_cast<cudaStream_t>(stream));
}

// The _dev entry of pft_fused_stage_shard: (ctl, stage) as
// pft_fused_stage_dev takes them, the shard options as
// pft_fused_stage_shard, and is_top: on the global top shard the combined
// u above plane Z-1 is the Dirichlet top decided on t_s, as in a
// single-device launch, and ghi holds the own edge planes (the mirror of
// p and gl).  A tail's eps must have exactly the launch's slots.  Returns
// as pft_fused_stage_shard; 1013 for a bad ctl or stage.
int pft_fused_stage_shard_dev(const float* consts, int mode, int nk,
                              int stage5, const void* ctl, int stage,
                              const float* coefs, const float* w,
                              const float* k0, const float* k1,
                              const float* k2, float* out, float* eps, int Z,
                              int Y, int X, void* stream, long long eps_n,
                              const float* glo, const float* ghi, int part,
                              int is_top, int r0, int Yl, int y0, int Yg) {
    StageArgs a;
    int bad = stage_args(a, nk, stage5, 0.0f, 0.0f, coefs, w, k0, k1, k2,
                         out, eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 0 || stage > 4) return 1013;
    ShardArgs sa{glo, ghi, part, r0, Yl, y0, Yg, is_top ? 1 : 0};
    bad = shard_check(sa, Z, Y);
    if (bad) return bad;
    a.vec = ghost_width(a.vec, glo, ghi);
    const DevStage d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const Consts*>(consts), a, sa, mode, nk,
                  stage5, static_cast<cudaStream_t>(stream), nullptr, &d);
}

// The float64 _dev entry: pft_fused_stage_dev on float64 planes, its
// constants (consts) and the c_a (coefs) float64 host arrays.  Stage
// `stage` reads the float64 stage time and scale of the control block
// (stage.cuh stage_scalars) and forms aux = w + (sum_a c_a K_a) s, so the
// c_a are those of merson_stages' sums: (1), (1, 1), (1, 3), (0.5, -1.5,
// 2) for stages 1-4.  Returns as pft_fused_stage_dev.
int pft_fused_stage_dev64(const double* consts, int mode, int nk, int stage5,
                          const void* ctl, int stage, const double* coefs,
                          const double* w, const double* k0, const double* k1,
                          const double* k2, double* out, double* eps, int Z,
                          int Y, int X, void* stream, long long eps_n) {
    StageArgsT<double> a;
    int bad = stage_args(a, nk, stage5, 0.0, 0.0, coefs, w, k0, k1, k2, out,
                         eps, eps_n, Z, Y, X);
    if (bad) return bad;
    if (!ctl || stage < 0 || stage > 4) return 1013;
    const DevStageT<double> d = dev_stage(ctl, stage, nk, coefs);
    return launch(*reinterpret_cast<const ConstsT<double>*>(consts), a,
                  whole_grid(Y), mode, nk, stage5,
                  static_cast<cudaStream_t>(stream), nullptr, &d);
}

// eps partial slots of a stage-5 launch of either entry over part (0 all,
// 1 interior, 2 edge) of Z planes and Yl own rows on the current device:
// the blocks of its grid; -1 for bad arguments or a failed query.
long long pft_stage_eps_blocks(int mode, int part, int Z, int Yl, int X) {
    if (part < PART_ALL || part > PART_EDGE || Z < (part ? 3 : 1) || Yl < 1
            || X < 1)
        return -1;
    StageArgs a{};
    a.g = Grid{Z, Yl, X};
    ShardArgs sa = whole_grid(Yl);
    sa.part = part;
    TileGrid sg;
    if (launch(Consts{}, a, sa, mode, 3, 1, nullptr, &sg)) return -1;
    return (long long)sg.grid.x * sg.grid.y * sg.grid.z;
}

// ... of pft_fused_stage_dev64's stage-5 launch over Z, Y, X
long long pft_stage_eps_blocks64(int mode, int Z, int Y, int X) {
    if (Z < 1 || Y < 1 || X < 1) return -1;
    StageArgsT<double> a{};
    a.g = Grid{Z, Y, X};
    const DevStageT<double> d{};
    TileGrid sg;
    if (launch(ConstsT<double>{}, a, whole_grid(Y), mode, 3, 1, nullptr, &sg,
               &d))
        return -1;
    return (long long)sg.grid.x * sg.grid.y * sg.grid.z;
}

}  // extern "C"
